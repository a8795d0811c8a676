"""The port stands alone: no module of ray_tpu_torch, and none of
chip_smoke.py, chip_ab.py and chip_tune_dq.py, imports JAX or anything of
ray_tpu (the machine with the card has no JAX), and importing the package
loads neither."""
import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _port_files():
    files = [os.path.join(REPO_ROOT, name)
             for name in ("chip_smoke.py", "chip_ab.py", "chip_tune_dq.py")]
    for dirpath, _dirnames, filenames in os.walk(os.path.join(REPO_ROOT, "ray_tpu_torch")):
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_port_files_are_found():
    files = [os.path.relpath(p, REPO_ROOT) for p in _port_files()]
    for expected in ("chip_smoke.py", "chip_ab.py", "chip_tune_dq.py",
                     "ray_tpu_torch/ops/attention.py",
                     "ray_tpu_torch/serve/llm_engine.py", "ray_tpu_torch/parallel/train_step.py"):
        assert expected in files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_or_ray_tpu_imports(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.models.paged") and _forbidden("jax.numpy")
    assert not _forbidden("ray_tpu_torch.models.paged") and not _forbidden("torch")


def test_import_loads_neither_jax_nor_ray_tpu():
    """In a fresh interpreter (this one already imported JAX): importing
    every module of the port leaves jax and ray_tpu out of sys.modules."""
    # Only modules that the port's imports bring in count: an interpreter
    # whose site hooks preload jax must not fail the check.
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import ray_tpu_torch, ray_tpu_torch.ops.attention, ray_tpu_torch.ops._build\n"
        "import ray_tpu_torch.models.transformer, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.models.generate, ray_tpu_torch.models.paged\n"
        "import ray_tpu_torch.serve.llm_engine, ray_tpu_torch.serve.metrics\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.train_step\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print('NEW', len(new), 'BAD', bad)\n"
        "sys.exit(1 if bad or 'ray_tpu_torch.serve.llm_engine' not in new\n"
        "         or 'ray_tpu_torch.parallel.train_step' not in new else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
