"""The port's dry run (``launch/dryrun.py``) on the CPU with no card.

A reduced-depth train combination and a decode combination end ``ok``
with every field of the record, a full-attention ``long_500k`` ends
``skipped`` with the reference's reason, a kernel asked for on the meta
device ends ``error`` with its message, the MoE dispatch variants count
on the meta device through the routing ops' shape rules, and the command
line writes its records and summary.  The full-depth sweep (``--all``) is run by hand:
its time goes to grok-1-314b's and qwen2-vl-72b's rounds.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import specs as jspecs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, hw, roofline  # noqa: E402
from repro_torch.launch.specs import INPUT_SHAPES, shape_applicable  # noqa: E402,E501

FIELDS = ("flops_per_rank", "hbm_bytes_per_rank", "peak_bytes_per_rank",
          "collectives", "collective_bytes_per_rank", "collective_count",
          "roofline", "model_flops_total", "model_flops_ratio",
          "fits_one_card", "arg_bytes_per_dev", "busy_ranks", "ranks")


def _cut(arch, n_layers):
    return get_config(arch).replace(n_layers=n_layers)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_at_reduced_depth_is_ok(multi_pod):
    cfg = _cut("qwen3-1.7b", 2)
    rec = dryrun.dry_run("qwen3-1.7b", "train_4k", multi_pod=multi_pod,
                         verbose=False, cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    for f in FIELDS:
        assert f in rec, f
    dp = 32 if multi_pod else 16
    assert (rec["C"], rec["H"], rec["b"]) == (dp, 4, 256 // (4 * dp))
    assert rec["ranks"] == rec["busy_ranks"] == dp
    n = sum(x.numel() for x in _leaves(cfg))
    # rank 0 trains one client; one fp32 all-reduce of the delta, one
    # all-gather of the cohort's losses
    assert rec["collectives"] == {
        "all-reduce": {"count": 1, "bytes": 4 * n},
        "all-gather": {"count": 1, "bytes": 4 * dp}}
    assert rec["flops_per_rank"] > 0 and rec["hbm_bytes_per_rank"] > 0
    assert rec["model_flops_ratio"] > 0
    mf = roofline.model_flops(cfg.n_active_params(), 256 * 4096,
                              backward=True)
    assert rec["model_flops_total"] == mf
    assert rec["fits_one_card"] == (rec["peak_bytes_per_rank"]
                                    <= hw.HBM_BYTES)
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))


def _leaves(cfg):
    from repro_torch.models import transformer as TT
    from repro_torch.tree import leaves
    return leaves(TT.abstract_params(cfg)[0])


def test_scan_placement_runs_the_whole_round_on_a_rank():
    cfg = _cut("grok-1-314b", 1)
    rec = dryrun.dry_run("grok-1-314b", "train_4k", verbose=False, cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["placement"] == "scan"
    assert (rec["C"], rec["H"], rec["b"]) == (4, 4, 16)
    assert rec["busy_ranks"] == 1 and rec["collectives"] == {}
    assert not rec["fits_one_card"]


def test_decode_is_ok_on_a_ranks_share_of_the_requests():
    rec = dryrun.dry_run("gemma3-1b", "decode_32k", verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rank_batch"] == 128 // 16 and rec["busy_ranks"] == 16
    assert rec["collectives"] == {} and rec["fits_one_card"]
    long = dryrun.dry_run("gemma3-1b", "long_500k", verbose=False)
    assert long["status"] == "ok" and long["rank_batch"] == 1
    assert long["busy_ranks"] == 1


def test_full_attention_long_500k_is_skipped_with_the_reference_reason():
    rec = dryrun.dry_run("qwen3-14b", "long_500k", verbose=False)
    assert rec["status"] == "skipped"
    _, why = jspecs.shape_applicable(
        "qwen3-14b", None, jspecs.INPUT_SHAPES["long_500k"])
    assert rec["reason"] == why
    assert shape_applicable("qwen3-14b", get_config("qwen3-14b"),
                            INPUT_SHAPES["long_500k"]) == (False, why)


def test_a_kernel_on_the_meta_device_is_an_error_not_a_count():
    cfg = _cut("gemma3-1b", 2).replace(attention_impl="pallas")
    rec = dryrun.dry_run("gemma3-1b", "prefill_32k", verbose=False, cfg=cfg)
    assert rec["status"] == "error"
    assert "flash_attention" in rec["error"]
    assert "flops_per_rank" not in rec


def test_variants_change_the_config_and_the_delta():
    cfg = _cut("gemma3-1b", 1)
    zero = dryrun.dry_run("gemma3-1b", "decode_32k", verbose=False, cfg=cfg)
    seq = dryrun.dry_run("gemma3-1b", "decode_32k", verbose=False, cfg=cfg,
                         variant="seq_cache")
    # the plan moves, the rank's count does not
    assert seq["arg_bytes_per_dev"] < zero["arg_bytes_per_dev"]
    assert seq["flops_per_rank"] == zero["flops_per_rank"]


def test_moe_dispatch_variants_count_through_the_shape_rules():
    """granite's train round, cut to one layer, routed by index
    (``kernels/moe_route``): the groups one after another and vmapped
    (``moe_vmap``, ``moe_vmap_bf16``) run on the meta device through the
    ops' shape rules, launch nothing, and count the same flops."""
    from repro_torch.kernels.moe_route import kernel as mr_kernel
    cfg = _cut("granite-moe-1b-a400m", 1)
    before = mr_kernel.launches
    flops = set()
    for variant in (None, "moe_vmap", "moe_vmap_bf16"):
        rec = dryrun.dry_run("granite-moe-1b-a400m", "train_4k",
                             verbose=False, cfg=cfg, variant=variant)
        assert rec["status"] == "ok", rec.get("traceback")
        flops.add(rec["flops_per_rank"])
    assert len(flops) == 1 and flops.pop() > 0
    assert mr_kernel.launches == before


def test_command_line_writes_records_and_summary(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    rc = dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                      "--both-meshes", "--json", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" and "traceback" not in r for r in recs)
    text = capsys.readouterr().out
    assert "2 combos: 2 ok, 0 skipped, 0 errors" in text
    assert text.count("[OK]") == 2
