"""No JAX in a measured process, and a reference that imports nothing of
the program."""
import ast
import glob
import os
import subprocess
import sys

from harness import nojax, spec

PROGRAM = ("dd3d_tpu_torch", "dd3d_tpu", "jax", "jaxlib", "flax")


def test_whole_top_level_names():
    assert nojax.loaded({"dd3d_tpu_torch", "dd3d_tpu_torch.models.dd3d", "torch", "numpy"}) == []
    assert nojax.loaded({"dd3d_tpu_torch.ops", "dd3d_tpu.models.dd3d"}) == ["dd3d_tpu"]
    assert nojax.loaded({"jax._src.core", "jaxlib", "flax.linen", "jaxtyping"}) == ["flax", "jax", "jaxlib"]


def test_reference_sources_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(spec.BENCH_DIR, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in PROGRAM, (path, name)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from reference import bounds, compare, dd3d_dla34, decode, plain, weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, spec.BENCH_DIR, *PROGRAM], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"


def test_a_serving_run_loads_no_jax(tmp_path):
    """The program's side of a run (its model, int8 calibration, serving
    entry) imports no JAX module; checked in a fresh process."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from harness import program, nojax; "
            "import json; cfg = json.load(open(sys.argv[3])); "
            "program.experiment_cfg(cfg); "
            "import dd3d_tpu_torch.models.postprocess, dd3d_tpu_torch.models.calibrate; "
            "print(nojax.loaded())")
    cfg = os.path.join(spec.BENCH_DIR, "configs", "kitti_dla34_int8.json")
    out = subprocess.run([sys.executable, "-c", code, spec.BENCH_DIR, spec.ROOT, cfg], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"
