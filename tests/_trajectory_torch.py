"""The port's counterpart of ``tests/_trajectory.py``: the same linreg
fleet, dataset and sampler seeds, optimizers and plan knobs, built from
``repro_torch`` on the CPU, so that a torch run and the JAX package's
``run_trajectory`` of one config can be held against each other.  It
imports JAX only where a function compares with it, so the spawned ranks
of ``tests/_mesh_cases_torch.py`` can use it without JAX.

    hist, state = run_torch("streaming-bucketed", "fedmom", rcfg, clients, 8)
    assert_matches_jax((hist, state), run_trajectory(...))
"""
import os

import numpy as np
import torch

from repro_torch.core import (DeviceDiurnalSampler, DeviceUniformSampler,
                              RoundConfig, fedavg, fedmom)
from repro_torch.data import FederatedDataset
from repro_torch.interop import tree_to_numpy
from repro_torch.launch.plan import CacheSpec, ExecutionPlan
from repro_torch.launch.train import FederatedTrainer

# tests/test_torch_trainer.py's tolerance: the engines agree on every keyed
# draw bit for bit and sum in other orders
LOSS_RTOL, W_RTOL, W_ATOL = 1e-4, 1e-4, 1e-5

_PLANE_OF = {"per-round": "per_round", "streaming": "streaming",
             "streaming-uniform": "streaming",
             "streaming-bucketed": "streaming", "scanned": "scanned",
             "device": "device", "auto": "auto"}


def linreg_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean(torch.square(pred - batch["y"])), {}


def opts(name):
    """(JAX optimizer, torch optimizer) of one name, the harness's
    settings (eta 1, beta 0.9)."""
    from repro import core as jcore
    if name == "fedmom":
        return (jcore.fedmom(eta=1.0, beta=0.9),
                fedmom(eta=1.0, beta=0.9, use_fused_kernel=True))
    return jcore.fedavg(eta=1.0), fedavg(eta=1.0)


def rcfg(clients_per_round=3, local_steps=4, lr=0.05):
    return RoundConfig(clients_per_round=clients_per_round,
                       local_steps=local_steps, lr=lr, placement="mesh",
                       compute_dtype="float32")


def diurnal_sampler_fn(m_min=2, m_max=5, period=7, seed=3):
    def fn(pop):
        return DeviceDiurnalSampler(pop, m_min=m_min, m_max=m_max,
                                    period=period, seed=seed)
    return fn


def make_trainer(opt, rc, clients, sampler_fn=None, hetero_fn=None,
                 local_batch=4, d=5, **kw):
    ds = FederatedDataset([dict(c) for c in clients], seed=1)
    sampler = (sampler_fn(ds.population()) if sampler_fn
               else DeviceUniformSampler(ds.population(),
                                         rc.clients_per_round, seed=2))
    w0 = {"w": torch.zeros(d), "b": torch.zeros(())}
    return FederatedTrainer(
        loss_fn=linreg_loss, server_opt=opt, rcfg=rc, dataset=ds,
        sampler=sampler, state=opt.init(w0), hetero_steps_fn=hetero_fn,
        local_batch=local_batch, device="cpu", **kw)


def plan_for(lane, chunk_rounds=8, **kw):
    """The ``ExecutionPlan`` of a lane; ``cache_clients`` / ``cache_bytes``
    / ``cache_tiers`` go to its ``CacheSpec``, the rest (such as
    ``memory_budget_bytes``) to the plan."""
    cache = CacheSpec(clients=kw.pop("cache_clients", None),
                      bytes=kw.pop("cache_bytes", None),
                      tiers=kw.pop("cache_tiers",
                                   1 if lane == "streaming-uniform"
                                   else None),
                      bucketed=lane == "streaming-bucketed")
    return ExecutionPlan(plane=_PLANE_OF[lane], chunk_rounds=chunk_rounds,
                         cache=cache, **kw)


def run_torch(lane, opt, rc, clients, n_rounds, *, sampler_fn=None,
              hetero_fn=None, chunk_rounds=8, local_batch=4, resume_at=None,
              tmp_path=None, client_step_fn=None, **plan_kw):
    """``run_trajectory``'s twin: ``n_rounds`` under ``lane`` in a fresh
    trainer; with ``resume_at`` the first trainer checkpoints every round
    and stops there, a second resumes.  Returns (history, final state)."""
    def mk(**extra):
        return make_trainer(opt, rc, clients, sampler_fn=sampler_fn,
                            hetero_fn=hetero_fn, local_batch=local_batch,
                            client_step_fn=client_step_fn, **extra)

    plan = plan_for(lane, chunk_rounds, **plan_kw)
    if resume_at is None:
        tr = mk()
        return strip_events(tr.run(n_rounds, plan=plan, verbose=False)), \
            tr.state
    ck = os.path.join(str(tmp_path), f"torch-{lane}-resume.npz")
    first = mk(ckpt_path=ck, ckpt_every=1)
    h1 = first.run(resume_at, plan=plan, verbose=False)
    second = mk(ckpt_path=ck, ckpt_every=1)
    h2 = second.run(n_rounds, plan=plan, verbose=False, resume=True)
    return strip_events(list(h1) + list(h2)), second.state


def strip_events(hist):
    """Trajectory records only (an auto run's plan record dropped)."""
    return [r for r in hist if "event" not in r]


def torch_flat_w(state):
    w = tree_to_numpy(state.w)
    return np.concatenate([np.ravel(w[k]) for k in sorted(w)])


def assert_matches_jax(got, want):
    """A torch (history, state) against a JAX one: equal round ids, losses
    within LOSS_RTOL, final parameters within W_RTOL / W_ATOL."""
    from _trajectory import flat_w
    (t_hist, t_state), (j_hist, j_state) = got, want
    t_hist, j_hist = strip_events(t_hist), strip_events(j_hist)
    assert [r["round"] for r in t_hist] == [r["round"] for r in j_hist]
    np.testing.assert_allclose([r["loss"] for r in t_hist],
                               [r["loss"] for r in j_hist], rtol=LOSS_RTOL)
    np.testing.assert_allclose(torch_flat_w(t_state), flat_w(j_state),
                               rtol=W_RTOL, atol=W_ATOL)
    assert int(t_state.t) == int(j_state.t)
