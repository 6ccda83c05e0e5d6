"""One run of a cell: set-up, the checked first rounds, the measured window
(or, traced, a profiled slice and the layers timed alone), the reference,
and the result line.

The window is the program's own entry point, ``FederatedTrainer.run(n,
plan=...)`` on the plane the mix pins, with ``n`` sized from a warm-up to
fill ``--seconds``.  On the chunked planes the window's ``eval_fn`` only
reads the host clock, at the cadence of ``chunk_rounds``, where the plane
already splits its chunks (each chunk's time a round goes to standard
error).  The window ends when every card of the cell has synchronised.

A mix with ``mesh_ranks`` > 1 runs one process a card (the program's
``launch.mesh.spawn``, NCCL): every rank runs the same trainer under
``ExecutionPlan(mesh=MeshSpec(devices=n))``, and the process that was
started runs the reference and prints the line.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from . import check, flops, timing, weights
from .families import Seeds, family
from .hw import FEDMOM_BYTES_PER_ELEMENT, HBM_BW, PEAK_FLOPS
from .spec import Cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SLICE_S = 0.5        # profiled seconds of rounds in a traced run


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tf32(config: dict):
    """The configuration's product precision: TF32 on or off."""
    on = bool(config["precision"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def recorded_cohorts(trainer, per_round: bool):
    """The client ids the trainer's rounds draw, a list a round, filled in
    round order as the call returns: on a chunked plane the ids that each
    chunk's graph returns beside its metrics, on the per-round plane each
    round's host draw."""
    got, ids = [], []
    if per_round:
        sample = trainer.sampler.sample

        def record(t=0):
            idx, w = sample(t)
            got.append(torch.as_tensor(np.asarray(idx))[None])
            return idx, w
        trainer.sampler.sample = record
    else:
        read_back = trainer._read_back

        def record(metrics, draws):
            got.append(metrics["clients"].clone())
            return read_back(metrics, draws)
        trainer._read_back = record
    try:
        yield ids
    finally:
        if per_round:
            del trainer.sampler.sample
        else:
            del trainer._read_back
    ids.extend([int(c) for c in row] for chunk in got
               for row in chunk.reshape(-1, chunk.shape[-1]).cpu())


class Program:
    """The system under test, built for one cell from one seed."""

    def __init__(self, cell: Cell, seed: int, device, fault: str = None):
        from repro_torch.core import DeviceUniformSampler, RoundConfig, fedmom
        from repro_torch.data.federated import FederatedDataset
        from repro_torch.launch.mesh import MeshSpec
        from repro_torch.launch.plan import ExecutionPlan
        from repro_torch.launch.train import FederatedTrainer

        self.cell, self.device = cell, device
        self.phases = {}
        cfg, mix = cell.config, cell.mix
        self.fam = family(cfg, mix)
        self.seeds = Seeds.of(seed)
        _tf32(cfg)
        self.shapes = self.fam.shapes()
        t = time.perf_counter()
        self.corpus = self.fam.make_corpus(self.seeds, device)
        _sync(device)
        self.phases["corpus_s"] = time.perf_counter() - t
        t = time.perf_counter()
        w0 = weights.draw(self.shapes, self.fam.rule, self.seeds.weights,
                          device)
        _sync(device)
        self.phases["weights_s"] = time.perf_counter() - t
        ds = FederatedDataset(self.corpus.program, seed=self.seeds.data)
        opt_cfg = cfg["optimizer"]
        self.eta = mix["clients"] / mix["m"]
        self.opt = fedmom(eta=self.eta, beta=opt_cfg["beta"],
                          use_fused_kernel=True)
        self.rcfg = RoundConfig(
            clients_per_round=mix["m"], local_steps=mix["local_steps"],
            lr=opt_cfg["lr"], placement="mesh",
            compute_dtype=cfg["precision"]["client_compute"])
        self.sampler = DeviceUniformSampler(ds.population(), mix["m"],
                                            seed=self.seeds.sample)
        loss_fn = self.fam.program_loss()
        if fault == "half_batch":
            base = loss_fn

            def loss_fn(params, batch):
                return base(params, {k: v[: v.shape[0] // 2]
                                     for k, v in batch.items()})
        state = self.opt.init(weights.nest(w0))
        del w0
        if fault == "state_unchanged":
            from repro_torch.core.server_opt import ServerOpt
            self.opt = ServerOpt("fedmom", self.opt.init_extra,
                                 lambda w, extra, delta, t: (w, extra))
        self.trainer = FederatedTrainer(
            loss_fn=loss_fn, server_opt=self.opt, rcfg=self.rcfg,
            dataset=ds, sampler=self.sampler, state=state,
            local_batch=mix["b"], device=device)
        ranks = int(mix.get("mesh_ranks", 1))
        self.plan = ExecutionPlan(
            plane=mix["plane"], chunk_rounds=int(mix.get("chunk_rounds", 1)),
            mesh=MeshSpec(devices=ranks) if ranks > 1 else None)

    # -- the checked first rounds -----------------------------------------
    def w0_leaf(self, path: str) -> torch.Tensor:
        return weights.draw_leaf(self.shapes, self.fam.rule,
                                 self.seeds.weights, path, self.device)

    def checked_rounds(self) -> dict:
        """Rounds 0..n-1 through the window's own call with its chunking:
        on a chunked plane a first chunk of one round, then one of
        ``chunk_rounds`` (``n`` = 1 + ``chunk_rounds``), the window's own
        graphs; on the per-round plane n rounds.  The state is read where
        the call seals round 0 and round n-1; the cohorts are the ids the
        program's rounds drew.  Returns what the comparison reads."""
        from ..reference.rounds import row_norms
        n = int(self.cell.mix["check_rounds"])
        out = {"delta0": {}, "change": {}, "delta0_rows": {},
               "change_rows": {}}
        seals = []

        def probe(state):
            seals.append(len(seals))
            if len(seals) == 1:
                v = weights.flatten(state.extra["v"])
                name, diff = "delta0", lambda p: (self.w0_leaf(p) - v[p]) \
                    / self.eta
            else:
                w = weights.flatten(state.w)
                name, diff = "change", lambda p: w[p] - self.w0_leaf(p)
            for p in self.shapes:
                d = diff(p)
                out[name][p] = float(torch.linalg.vector_norm(d))
                out[name + "_rows"][p] = row_norms(d)
                del d
            return {}

        per_round = self.cell.mix["plane"] == "per_round"
        with recorded_cohorts(self.trainer, per_round) as cohorts:
            hist = self.trainer.run(n, plan=self.plan, eval_fn=probe,
                                    log_every=n - 1, verbose=False)
        self._check_plane()
        if len(seals) != 2:
            raise RuntimeError(f"the checked rounds sealed {len(seals)} "
                               f"times, not at round 0 and round {n - 1}")
        out["losses"] = [float(r["loss"]) for r in hist[-n:]]
        out["cohorts"] = cohorts
        return out

    def _check_plane(self):
        rec = self.trainer.session.plan_log[-1]
        if rec["plane"] != self.cell.mix["plane"]:
            raise RuntimeError(f"the plan resolved to plane {rec['plane']!r},"
                               f" not the cell's {self.cell.mix['plane']!r}")

    # -- the window -------------------------------------------------------
    @property
    def chunk(self) -> int:
        mix = self.cell.mix
        return int(mix["chunk_rounds"]) if mix["plane"] != "per_round" else 0

    def _run(self, n: int, probe=None):
        c = self.chunk
        if c:
            # the first chunk ends at the eval round 0; the rest are whole
            return self.trainer.run(n, plan=self.plan,
                                    eval_fn=probe or (lambda s: {}),
                                    log_every=c, verbose=False)
        return self.trainer.run(n, plan=self.plan, verbose=False)

    def warm_and_size(self, seconds: float) -> int:
        """Warm every shape the window uses; the rounds that fill
        ``seconds`` (whole chunks after the first round on the chunked
        planes), timed from one more warm call."""
        c = self.chunk
        if c:
            self._run(1 + c)                         # captures the chunk
        n_est = 1 + c if c else 1
        _sync(self.device)
        t0 = time.perf_counter()
        self._run(n_est)
        _sync(self.device)
        per_round = (time.perf_counter() - t0) / n_est
        want = max(1, round(seconds / max(per_round, 1e-6)))
        return 1 + c * max(1, round((want - 1) / c)) if c else want

    def window(self, n: int, barrier=None) -> dict:
        stamps = []

        def clock(state):
            stamps.append(time.perf_counter())
            return {}

        _sync(self.device)
        if barrier:
            barrier()
        start = time.time()
        t0 = time.perf_counter()
        hist = self._run(n, clock if self.chunk else None)
        _sync(self.device)
        if barrier:
            barrier()
        t1 = time.perf_counter()
        self._check_plane()
        losses = [r["loss"] for r in hist[-n:]]
        out = {"rounds": n, "seconds": t1 - t0, "start_epoch": start,
               "failed": sum(not math.isfinite(x) for x in losses)}
        c = self.chunk
        if c and len(stamps) > 2:
            out["chunk_ms"] = [(b - a) * 1e3 / c
                               for a, b in zip(stamps[1:], stamps[2:])]
        return out

    # -- the traced run ---------------------------------------------------
    def traced(self, n: int) -> dict:
        """A slice of ``n`` rounds timed by the host clock, the same slice
        profiled, then each layer's call timed alone at the cell's
        shapes."""
        _sync(self.device)
        t0 = time.perf_counter()
        self._run(n)
        _sync(self.device)
        plain = time.perf_counter() - t0
        wall, events = timing.device_events(lambda: self._run(n))
        rec = timing.summarize(wall, events)
        rec["rounds"] = n
        rec["plain_wall_s"] = plain
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            self.device)
        rec["timings"] = self.layer_timings()
        return rec

    def _cohort_batches(self):
        """Round 0's batch stack of the clients one card trains (its block
        of the cohort on a mesh) at the cell's shapes, on the card."""
        mix = self.cell.mix
        key = self.sampler.base_key().to(self.device)
        per_card = -(-mix["m"] // int(mix.get("mesh_ranks", 1)))
        ids = self.sampler.sample_device(key, 0)[0][:per_card]
        if mix["plane"] == "device":
            dds = self.trainer.device_dataset()
            return dds.gather_round_batch(dds.base_key(), 0, ids,
                                          mix["local_steps"], mix["b"])
        host = self.trainer.dataset.round_batches(
            ids.cpu().numpy(), mix["local_steps"], mix["b"], t=0)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host.items()}

    def layer_timings(self) -> dict:
        from torch.func import vmap
        from repro_torch.core import client as client_lib
        from repro_torch.core.round import DTYPES
        from repro_torch.data.federated import minibatch_indices
        from repro_torch.optim.local import sgd
        from repro_torch.tree import tree_map

        mix, dev = self.cell.mix, self.device
        graphed = mix["plane"] in ("device", "scanned")
        timed = ((lambda fn, it: timing.graph_ms(fn, iters=it))
                 if graphed else
                 (lambda fn, it: timing.cuda_ms(fn, iters=max(2, it // 4))))
        heavy = mix["plane"] == "per_round"
        out = {}
        state = self.trainer.state
        delta = tree_map(torch.zeros_like, state.w)
        out["server_step_ms"] = timed(
            lambda: self.opt.update(state, delta), 4 if heavy else 20)
        del delta
        batches = self._cohort_batches()
        w_c = tree_map(lambda x: x.to(DTYPES[self.rcfg.compute_dtype]),
                       state.w)
        lr = torch.full((), self.rcfg.lr, dtype=torch.float32, device=dev)
        loss_fn = self.trainer.loss_fn

        def local():
            return vmap(lambda b: client_lib.local_update(
                loss_fn, w_c, b, lr, sgd()))(batches)
        out["local_update_ms"] = timed(local, 2 if heavy else 10)
        del w_c
        if mix["plane"] == "device":
            dds = self.trainer.device_dataset()
            key = self.sampler.base_key().to(dev)
            t = torch.zeros((), dtype=torch.int64, device=dev)
            need = mix["local_steps"] * mix["b"]
            ids, _ = self.sampler.sample_device(key, t)
            dkey = dds.base_key()

            def sample():
                i, _ = self.sampler.sample_device(key, t)
                return minibatch_indices(dkey, t, i.long(),
                                         dds.counts[i.long()], need)
            out["sample_ms"] = timed(sample, 20)
            out["gather_ms"] = timed(
                lambda: dds.gather_round_batch(dkey, t, ids,
                                               mix["local_steps"], mix["b"]),
                20)
        if self.cell.config["family"] == "moe_lm":
            out["moe_layer_ms"] = self.moe_layer_ms()
        return out

    def moe_layer_ms(self) -> float:
        """Layer 0's MoE MLP, forward and backward, on one client step's
        tokens in the client compute dtype."""
        from repro_torch.models import layers as L
        mix, m = self.cell.mix, self.cell.config["model"]
        dt = getattr(torch, self.cell.config["precision"]["client_compute"])
        mlp = self.trainer.state.w["groups"]["b0"]["mlp"]
        p = {k: v[0].detach().to(dt).requires_grad_(True)
             for k, v in mlp.items()}
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seeds.weights)
        x = torch.randn((mix["b"], mix["seq"], m["d_model"]), generator=g,
                        device=self.device).to(dt).requires_grad_(True)

        def step():
            y, aux = L.moe_apply(p, x, n_experts=m["n_experts"],
                                 top_k=m["top_k"],
                                 capacity_factor=m["capacity_factor"],
                                 act="swiglu")
            (y.float().sum() + aux).backward()
        return timing.cuda_ms(step, iters=5)

    def free(self):
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(cell: Cell, seed: int, device, prec: str = "fp32") -> dict:
    """The plain reference's checked rounds from the same seed."""
    from ..reference import rounds
    fam = family(cell.config, cell.mix)
    seeds = Seeds.of(seed)
    corp = fam.make_corpus(seeds, device)
    w0 = weights.draw(fam.shapes(), fam.rule, seeds.weights, device)
    mix, opt = cell.mix, cell.config["optimizer"]
    return rounds.run(
        fam.ref_loss(), fam.ref_batches(), fam.ref_clients(corp, device),
        corp.counts, w0, rounds=int(mix["check_rounds"]), m=mix["m"],
        local_steps=mix["local_steps"], b=mix["b"], lr=opt["lr"],
        eta=mix["clients"] / mix["m"], beta=opt["beta"],
        sample_seed=seeds.sample, data_seed=seeds.data,
        store=cell.config["precision"]["client_compute"], prec=prec)


# ---------------------------------------------------------------------------
# one process a card
# ---------------------------------------------------------------------------
def rank_main(rank: int, n: int, dev, cell: Cell, seed: int, seconds: float,
              trace: bool, fault: str = None, check_only: bool = False
              ) -> dict:
    """What one card does: the program's set-up, checked rounds and window
    (or traced slice; neither with ``check_only``).  Returns its
    readings."""
    barrier = None
    if n > 1:
        import torch.distributed as dist
        if fault == "no_exchange":
            from repro_torch.launch import mesh as mesh_lib
            mesh_lib.Mesh.all_reduce_ = lambda self, x: x

        def barrier():
            dist.barrier()
    prog = Program(cell, seed, dev, fault=fault)
    t = time.perf_counter()
    out = {"rank": rank, "check": prog.checked_rounds()}
    prog.phases["checked_rounds_s"] = time.perf_counter() - t
    out["phases"] = prog.phases
    if check_only:
        prog.free()
        return out
    t = time.perf_counter()
    rounds = prog.warm_and_size(TRACE_SLICE_S if trace else seconds)
    prog.phases["warm_s"] = time.perf_counter() - t
    if n > 1:
        t = torch.tensor([rounds], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        rounds = int(t.item())
    if trace:
        if barrier:
            barrier()
        out["trace"] = prog.traced(max(rounds, 1 if prog.chunk else 2))
        out["window"] = {"rounds": out["trace"]["rounds"], "failed": 0}
        out["memory_peak_bytes"] = out["trace"]["memory_peak_bytes"]
    else:
        out["window"] = prog.window(rounds, barrier)
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
    out["round_flops"] = prog.fam.round_flops()
    out["tree_elements"] = flops.tree_elements(prog.shapes)
    out["forbidden"] = forbidden_modules()
    prog.free()
    return out


def end_to_end(cell: Cell, r0: dict, peak: int, t_start: float) -> dict:
    """The cell's end-to-end metrics; a metric ``q.variant`` reads the
    quantity ``q`` (``round_ms.per_round`` is the window's ``round_ms``)."""
    win = r0["window"]
    vals = {"round_ms": win["seconds"] * 1e3 / win["rounds"],
            "peak_mem_gb": peak / 1e9,
            "setup_s": win["start_epoch"] - t_start}
    out = {}
    for m in cell.end_to_end:
        base = m["name"].split(".")[0]
        if base in vals:
            out[m["name"]] = {"value": vals[base], "unit": m["unit"]}
    return out


def per_layer(cell: Cell, ranks: list) -> dict:
    rec = {"config": cell.config, "mix": cell.mix,
           "ranks": [r["trace"] for r in ranks],
           "round_flops": ranks[0]["round_flops"],
           "tree_elements": ranks[0]["tree_elements"],
           "peak_flops": PEAK_FLOPS[cell.config["precision"]["mfu_peak"]],
           "hbm_bw": HBM_BW, "fedmom_bytes": FEDMOM_BYTES_PER_ELEMENT,
           "chips": cell.chips}
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[k[:120], s] for k, (s, _) in ops],
            "idle_gaps": [[name, s] for s, name in trace["gaps"]]}


def program_ranks(cell: Cell, seed: int, seconds: float, trace: bool,
                  device, fault: str = None, check_only: bool = False
                  ) -> list:
    """Every card's readings: one process a card on a mesh, else this
    process."""
    n = int(cell.mix.get("mesh_ranks", 1))
    args = (cell, seed, seconds, trace, fault, check_only)
    if n > 1:
        from repro_torch.launch.mesh import spawn
        return spawn(rank_main, n, device=device, args=args, timeout=330.0)
    return [rank_main(0, 1, device, *args)]


def _release(device):
    """Hand this process's cached card memory back: the next seed's ranks
    of a mesh start on the same cards."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def control_numbers(cell: Cell, seed: int, device, prec: str) -> dict:
    """The control: the reference in the program's place, its products in
    ``prec``, against the reference itself."""
    low = reference(cell, seed, device, prec)
    out = check.numbers(low, reference(cell, seed, device))
    _release(device)
    return out


def check_numbers(cell: Cell, seed: int, device, fault: str = None) -> dict:
    """The compared numbers of the program's checked rounds alone (no
    window), optionally with a fault planted."""
    ranks = program_ranks(cell, seed, 0.0, False, device, fault, True)
    _release(device)
    out = check.numbers(ranks[0]["check"], reference(cell, seed, device))
    _release(device)
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str = None) -> dict:
    """One run of ``cell``; returns the result line as a dict (``checks``
    last), the comparison's numbers under ``_numbers`` and the JAX
    modules each card's process had loaded under ``_forbidden``."""
    n = int(cell.mix.get("mesh_ranks", 1))
    ranks = program_ranks(cell, seed, seconds, trace, device, fault)
    r0 = ranks[0]
    peak = max(r["memory_peak_bytes"] for r in ranks)
    _release(device)
    ref = reference(cell, seed, device)
    nums = check.numbers(r0["check"], ref)
    correct, checks = check.judge(nums, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": n if n > 1 else cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": int(r0["window"]["rounds"]),
           "failed": int(r0["window"]["failed"])}
    if trace:
        out["metrics"] = per_layer(cell, ranks)
        dev["busy_s"] = statistics.mean(r["trace"]["busy_s"] for r in ranks)
        dev["window_s"] = r0["trace"]["wall_s"]
        out["device"] = dev
        out["breakdown"] = breakdown(r0["trace"])
    else:
        out["metrics"] = end_to_end(cell, r0, peak, t_start)
        out["device"] = dev
    out["checks"] = checks
    out["_numbers"] = nums
    out["_forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    out["_phases"] = r0["phases"]
    out["_chunk_ms"] = r0["window"].get("chunk_ms")
    return out
