"""Print the JAX package's per-chip FLOPs (``analyze_hlo``) of SMOKE cells
on several meshes (a development script: not part of the package or its
tests; it runs the reference on the CPU over 8 forced host devices).

    PYTHONPATH=src python dev/reference_flops.py qwen2.5-14b-h5kv1 hymba-1.5b-h6kv3

Each argument is an arch, or a variant of ``VARIANTS`` (an arch's SMOKE
config with fields replaced, as ``tests/tp_ranks.py`` makes them).  For
each mesh of ``MESHES`` (``("pod", "data", "model")``) and each kind
(train, prefill, decode) at a sequence of 64 and a batch of 8 (the cells
``tests/test_torch_dryrun.py`` holds the port to), one line: the mesh, the
arch and kind, and the FLOPs a chip.  Comparing meshes of one batch shard a
chip (``(2, 4, 1)``) with meshes that split ``model`` shows which work the
reference's XLA splits evenly and which it repeats on every ``model`` rank.
"""
import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.configs import get_config  # noqa: E402
from repro.launch import steps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.config import ShapeConfig  # noqa: E402

VARIANTS = {"qwen2.5-14b-h5kv1": ("qwen2.5-14b", dict(n_heads=5,
                                                      n_kv_heads=1)),
            "hymba-1.5b-h6kv3": ("hymba-1.5b", dict(n_heads=6,
                                                    n_kv_heads=3))}
MESHES = ((2, 4, 1), (2, 2, 2), (1, 2, 4))
AXES = ("pod", "data", "model")
SEQ, BATCH = 64, 8


def _config(name, smoke=False):
    arch, changes = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_config(arch, smoke=smoke), **changes)


def main(archs) -> None:
    recipe = steps.recipe_for
    steps.get_config = _config
    steps.recipe_for = lambda name, shape: recipe(
        VARIANTS.get(name, (name,))[0], shape)
    for shape in MESHES:
        mesh = make_mesh(shape, AXES)
        for arch in archs:
            for kind in ("train", "prefill", "decode"):
                cell = steps.build_cell(arch, ShapeConfig(
                    f"{kind}_s", SEQ, BATCH, kind), mesh, smoke=True)
                with mesh:
                    compiled = cell.lower().compile()
                flops = analyze_hlo(compiled.as_text(), pod_size=8).flops
                print(shape, arch, kind, flops, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
