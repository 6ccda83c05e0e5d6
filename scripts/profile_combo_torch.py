"""Where one (arch x shape x variant) of the port's dry run spends its
bytes and flops (the port's ``scripts/profile_combo.py``).

    PYTHONPATH=src python scripts/profile_combo_torch.py qwen3-1.7b decode_32k [variant]

It builds the step as ``repro_torch.launch.dryrun`` does (``rules_for``,
``build_train`` / ``build_serve``, the variant's config change from
``_CONFIG_VARIANTS``) on the meta device, counts it as rank 0 of the data
mesh with ``launch/cost.py`` (``analyze``, then ``profile(top=30)``), and
prints the reference script's header line (flops, bytes, collective bytes
of one rank), the collectives, and the thirty sites that move the most
bytes.  Nothing is allocated and no card is needed: it runs on any
machine's CPU.
"""
import sys

from repro_torch.configs import get_config
from repro_torch.launch import cost
from repro_torch.launch.dryrun import (_CONFIG_VARIANTS, build_serve,
                                       build_train, rules_for)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import INPUT_SHAPES, dp_axes, placement_for
from repro_torch.sharding import axis_rules


def profile_combo(arch: str, shape_name: str, variant: str = "zero",
                  top: int = 30) -> tuple:
    """(``cost.analyze``'s record, ``cost.profile``'s rows) of one rank's
    step of the combination, counted as ``dry_run`` counts it."""
    cfg = get_config(arch)
    if variant in _CONFIG_VARIANTS:
        cfg = cfg.replace(**_CONFIG_VARIANTS[variant])
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh()
    rules = rules_for(placement_for(arch), variant, shape.kind)
    build = build_train if shape.kind == "train" else build_serve
    fn, args, _ = build(arch, cfg, shape, mesh, variant, rules)
    ranks = cost.RecordingMesh({a: mesh[a] for a in dp_axes(mesh)})
    with axis_rules(ranks, rules):
        res = cost.analyze(fn, *args)
        rows = cost.profile(fn, *args, top=top)
    return res, rows


def main(arch, shape_name, variant="zero"):
    res, rows = profile_combo(arch, shape_name, variant)
    print(f"== {arch} x {shape_name} [{variant}]  "
          f"flops={res['flops']:.3e} bytes={res['bytes']:.3e} "
          f"coll={res['collective_bytes']:.3e}")
    print(f"   collectives: {res['collectives']}")
    print(f"{'bytes':>12s} {'flops':>12s}  site")
    for name, b, f in rows:
        print(f"{b:12.3e} {f:12.3e}  {name}")


if __name__ == "__main__":
    main(*sys.argv[1:])
