"""The port stands alone: no module under tpu_dra_torch/ (the decode
mesh's parallel/ package and the serving tier's serving/ and infra/
included), and not chip_smoke.py, the ablation
scripts that run beside it on the card (int8mm_ablation.py,
decode_mlp_ablation.py, decode_attention_ablation.py,
l2_flush_ablation.py) or the rank helpers of the
gloo twins (tests/torch_{sharded,mesh,seqpar,train,pipeline}_rank.py),
imports jax, flax or anything of the JAX package (tpu_dra). The card's
machine has no JAX, and the JAX package is the reference the port is
held to, never a dependency of it."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_dra")


def _port_files():
    files = sorted((REPO / "tpu_dra_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "int8mm_ablation.py",
              REPO / "decode_mlp_ablation.py", REPO / "l2_flush_ablation.py",
              REPO / "decode_attention_ablation.py",
              REPO / "tests" / "torch_sharded_rank.py"]
    files += [REPO / "tests" / f"torch_{name}_rank.py"
              for name in ("mesh", "seqpar", "train", "pipeline")]
    return files


def test_decode_mesh_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"tpu_dra_torch/workloads/parallel/__init__.py",
            "tpu_dra_torch/workloads/parallel/mesh.py",
            "tpu_dra_torch/workloads/shardbench.py",
            "tests/torch_sharded_rank.py"} <= names


def test_training_mesh_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"tpu_dra_torch/workloads/parallel/context.py",
            "tpu_dra_torch/workloads/parallel/ring_attention.py",
            "tpu_dra_torch/workloads/parallel/ulysses.py",
            "tests/torch_mesh_rank.py", "tests/torch_seqpar_rank.py",
            "tests/torch_train_rank.py"} <= names


def test_pipeline_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"tpu_dra_torch/workloads/parallel/pipeline.py",
            "tpu_dra_torch/workloads/pipestep.py",
            "tests/torch_pipeline_rank.py"} <= names


def test_serving_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"tpu_dra_torch/serving/__init__.py",
            "tpu_dra_torch/serving/router.py",
            "tpu_dra_torch/serving/faults.py",
            "tpu_dra_torch/serving/autoscaler.py",
            "tpu_dra_torch/infra/__init__.py",
            "tpu_dra_torch/infra/deadline.py",
            "tpu_dra_torch/infra/trace.py",
            "tpu_dra_torch/infra/lockdep.py"} <= names


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files), [f for f in files if not f.exists()]
    assert len(files) >= 10


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_or_reference_imports(path):
    bad = [
        f"{path.relative_to(REPO)}:{line} imports {root}"
        for line, root in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_scanner_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\n"
        "from tpu_dra.workloads import engine\n"
        "from tpu_dra.computedomain.daemon.bootstrap import "
        "read_bootstrap_env\n"
        "import importlib\n"
        "importlib.import_module('flax.linen')\n"
    )
    roots = [root for _, root in _imported_roots(probe)]
    assert {"jax", "tpu_dra", "flax"} <= set(roots)
    assert roots.count("tpu_dra") == 2
