"""What the spawned gloo ranks of ``tests/test_torch_mesh.py`` run.

Each rank is a fresh process (``repro_torch.launch.mesh.spawn``), so this
module imports torch and the port only.  ``rank_cases`` runs every case
in one set of ranks and returns plain numbers and arrays; the test file
holds them against the JAX package's single-device trajectories and the
port's own.
"""
import os

import numpy as np
import torch

from _trajectory_torch import (make_trainer, plan_for, rcfg, strip_events,
                               torch_flat_w)
from repro_torch.core import SecureAggSpec, fedmom
from repro_torch.data import (DeviceFederatedDataset, FederatedDataset,
                              StreamingFederatedDataset)
from repro_torch.kernels.client_step.ops import linreg_tier_step
from repro_torch.launch.mesh import MeshSpec
from repro_torch.sharding import FED_MESH_RULES, axis_rules
from repro_torch.tree import leaves

# the reference's tests/test_mesh_shard.py: 8 clients, M=4 (one client a
# shard on 4 ranks), rounds and chunks as there
N_CLIENTS, M = 8, 4
LANES = ("per-round", "scanned", "device", "streaming", "streaming-bucketed",
         "auto")
MASKED = SecureAggSpec(masked=True, seed=5)


def dropouts():
    """The scenario of the masked dropout-recovery cases."""
    from repro_torch.scenario import ScenarioSpec, UniformDropout
    return ScenarioSpec(dropout=UniformDropout(rate=0.4), seed=11)


def opt():
    return fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)


def trajectory(lane, clients, n_rounds, *, m=M, mesh=None, hook=False,
               resume_at=None, tmp=None, **plan_kw):
    """(losses, delta_norms, flat params, t, last plan record) of one run
    on the CPU; ``resume_at``: a first trainer checkpoints every round and
    stops there, a second resumes."""
    plan = plan_for(lane, chunk_rounds=4, mesh=mesh, **plan_kw)
    kw = {"client_step_fn": linreg_tier_step()} if hook else {}

    def mk(**extra):
        return make_trainer(opt(), rcfg(clients_per_round=m), clients, **kw,
                            **extra)

    if resume_at is None:
        tr = mk()
        hist = tr.run(n_rounds, plan=plan, verbose=False)
    else:
        ck = os.path.join(tmp, f"{lane}-resume.npz")
        first = mk(ckpt_path=ck, ckpt_every=1)
        hist = list(first.run(resume_at, plan=plan, verbose=False))
        tr = mk(ckpt_path=ck, ckpt_every=1)
        hist += tr.run(n_rounds, plan=plan, verbose=False, resume=True)
    hist = strip_events(hist)
    return {"loss": [r["loss"] for r in hist],
            "delta_norm": [r["delta_norm"] for r in hist],
            "round": [r["round"] for r in hist],
            "completed": [r.get("completed") for r in hist],
            "w": torch_flat_w(tr.state), "t": int(tr.state.t),
            "plan": tr.session.plan_log[-1],
            "nbytes": (tr.session.device_ds.nbytes
                       if tr.session.device_ds is not None else None),
            "cache_nbytes": (tr.stream_cache.nbytes
                             if tr.stream_cache is not None else None)}


def odd_clients(clients):
    """The fleet with signed zeros and NaNs planted in its features: an
    exchange that adds zero-filled rows instead of selecting them would
    turn -0.0 into +0.0."""
    out = [dict(c) for c in clients]
    for k, c in enumerate(out):
        x = c["x"].copy()
        x[0, 0] = -0.0
        x[1, 1] = np.nan if k % 2 else -0.0
        out[k] = dict(c, x=x)
    return out


def gather_blocks(clients, n, dev):
    """This rank's block of several rounds' cohorts gathered from the
    sharded corpus, and the same rows of the unsharded gather, as raw
    bytes; and the sharded corpus's bytes."""
    ds = FederatedDataset(odd_clients(clients), seed=1)
    full = DeviceFederatedDataset.from_federated(ds, device=dev)
    mesh = MeshSpec(devices=n).build(dev)
    with axis_rules(mesh, FED_MESH_RULES):
        sharded = DeviceFederatedDataset.from_federated(ds, device=dev)
    key = full.base_key()
    cohorts = ([0, 7, 3, 3], [5, 1, 6], [2], list(range(N_CLIENTS)),
               [7, 7, 7, 0, 0])
    got, want = [], []
    for t, cids in enumerate(cohorts):
        cids = torch.as_tensor(cids)
        lo, hi = mesh.block(len(cids))
        b = sharded.gather_round_block(key, t, cids, 2, 3, mesh)
        f = full.gather_round_batch(key, t, cids, 2, 3)
        got.append({k: v.contiguous().view(torch.uint8).numpy()
                    for k, v in b.items()})
        want.append({k: v[lo:hi].contiguous().view(torch.uint8).numpy()
                     for k, v in f.items()})
    return {"got": got, "want": want, "nbytes": sharded.nbytes,
            "full_nbytes": full.nbytes,
            "rows": int(next(iter(sharded.arrays.values())).shape[0])}


def lm_round(n, dev):
    """One round of reduced qwen3 in fp32 (the reference's
    tests/test_dryrun_host.py configuration: C=2, H=2, B=2, S=32) plain
    and under ``axis_rules`` with ``FED_MESH_RULES`` (batch unmapped, as
    there) over the live mesh: (loss, flat params) of each."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.core import RoundConfig, round_step
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-1.7b").reduced().replace(dtype="float32")
    params, axes = T.init(cfg, prng.PRNGKey(0), device=dev)
    rng = np.random.default_rng(1)
    C, H, B, S = 2, 2, 2, 32
    batches = {k: rng.integers(0, cfg.vocab, (C, H, B, S)).astype(np.int32)
               for k in ("tokens", "labels")}
    weights = np.asarray([0.4, 0.1], np.float32)
    o = fedmom(eta=1.0, beta=0.9)
    rc = RoundConfig(C, H, 0.05, "mesh", compute_dtype="float32")

    def one():
        state, m = round_step(lambda p, b: T.loss_fn(p, cfg, b), o,
                              o.init(params), batches, weights, rc,
                              param_axes=axes, device=dev)
        return float(m["loss"]), np.concatenate(
            [x.detach().reshape(-1).numpy() for x in leaves(state.w)])

    plain = one()
    mesh = MeshSpec(devices=n).build(dev)
    with axis_rules(mesh, dict(FED_MESH_RULES, batch=None)):
        sharded = one()
    return {"plain": plain, "mesh": sharded}


def packed_nbytes(clients) -> int:
    return StreamingFederatedDataset([dict(c) for c in clients],
                                     seed=1).packed_nbytes


def flip_budget(clients) -> int:
    """A budget between ceil(packed / 4) and packed: the device plane is
    out on one device and in on a 2- or 4-way mesh."""
    return packed_nbytes(clients) // 2


def lenet_round3_jump(noise=1e-8):
    """BENCH_10's LeNet trainer (``benchmarks/perf_compare.py``
    ``_driver_setup``: K=20, M=8, H=4, b=10, FedMom eta 2) after two
    per-round rounds; round 3 from that state and from the state with
    ``noise``-scaled Gaussian noise added: the largest parameter change
    and the number of parameters that move by more than 1e-6."""
    from repro_torch import random as prng
    from repro_torch.core import DeviceUniformSampler, RoundConfig
    from repro_torch.core.round import round_step
    from repro_torch.data import synthetic_femnist
    from repro_torch.launch.train import FederatedTrainer
    from repro_torch.models import small
    clients, _ = synthetic_femnist(n_clients=20, seed=0)
    ds = FederatedDataset(clients, seed=1)
    o = fedmom(eta=2.0, beta=0.9)
    tr = FederatedTrainer(
        loss_fn=small.lenet_loss, server_opt=o,
        rcfg=RoundConfig(8, 4, 0.05, compute_dtype="float32"), dataset=ds,
        sampler=DeviceUniformSampler(ds.population(), 8, seed=2),
        state=o.init(small.lenet_init(prng.PRNGKey(0), device="cpu")),
        local_batch=10, device="cpu")
    tr.run(2, plan="per_round", verbose=False)
    batches, weights, lr, _ = tr._round_inputs(2)
    gen = torch.Generator().manual_seed(0)
    nudged = tr.state._replace(w={
        k: v + noise * torch.randn(v.shape, generator=gen)
        for k, v in tr.state.w.items()})
    out = []
    for state in (tr.state, nudged):
        s3, _ = round_step(small.lenet_loss, o, state, batches, weights,
                           tr.rcfg, lr=lr, device="cpu")
        out.append(np.concatenate([x.reshape(-1).numpy()
                                   for x in leaves(s3.w)]))
    d = np.abs(out[0] - out[1])
    return float(d.max()), int((d > 1e-6).sum())


def rank_cases(rank, n, dev, clients, tmp):
    """Every mesh case of the test file, run over ``n`` ranks."""
    mesh = MeshSpec(devices=n)
    out = {lane: trajectory(lane, clients, 12, mesh=mesh) for lane in LANES}
    out["hook"] = trajectory("streaming-bucketed", clients, 12, mesh=mesh,
                             hook=True)
    out["uneven"] = trajectory("device", clients, 8, m=3, mesh=mesh)
    out["straight"] = trajectory("streaming", clients, 10, mesh=mesh)
    out["resumed"] = trajectory("streaming", clients, 10, mesh=mesh,
                                resume_at=5, tmp=tmp)
    for lane in ("device", "per-round"):
        out[f"masked-{lane}"] = trajectory(lane, clients, 8, mesh=mesh,
                                           secure=MASKED)
    out["masked-hook"] = trajectory("streaming-bucketed", clients, 8,
                                    mesh=mesh, hook=True, secure=MASKED)
    for lane in ("device", "per-round", "hook"):
        out[f"masked-dropout-{lane}"] = trajectory(
            "streaming-bucketed" if lane == "hook" else lane, clients, 8,
            mesh=mesh, hook=lane == "hook", secure=MASKED,
            scenario=dropouts())
    out["auto-flip"] = trajectory("auto", clients, 4, mesh=mesh,
                                  memory_budget_bytes=flip_budget(clients))
    out["gather"] = gather_blocks(clients, n, dev)
    if n == 2:
        out["lm"] = lm_round(n, dev)
    return out


def prefetch_runs(rank, n, dev, clients, n_rounds):
    """The padded streaming lane over ``n`` ranks with ``prefetch`` 0 and
    2, in one-round chunks over a cache of 3 uniform slots a shard, so that
    span i+1 evicts clients that chunk i reads: {prefetch: (losses, flat
    params, per-chunk cache records)}."""
    out = {}
    for p in (0, 2):
        tr = make_trainer(opt(), rcfg(), clients)
        hist = strip_events(tr.run(n_rounds, plan=plan_for(
            "streaming", chunk_rounds=1, mesh=MeshSpec(devices=n),
            cache_clients=3, cache_tiers=1, prefetch=p), verbose=False))
        out[p] = ([r["loss"] for r in hist], torch_flat_w(tr.state),
                  [{k: v for k, v in r.items() if k.startswith("cache_")}
                   for r in hist if "cache_hits" in r])
    return out


def fail_on_rank1(rank, n, dev):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def sleep(rank, n, dev, seconds):
    import time
    time.sleep(seconds)
