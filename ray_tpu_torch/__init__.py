"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's JAX half.

The package mirrors ``ray_tpu``'s layout (``ops/``, ``models/``,
``parallel/``, ``serve/``) with PyTorch inside. It imports ``torch`` and never ``jax``,
and nothing of ``ray_tpu``: what it needs from there it keeps as its own
copy. Importing it loads no CUDA code; each hand-written kernel is built
from ``ops/csrc`` at its first launch.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``; the tests pass ``"cpu"``, where each kernel wrapper runs its
plain PyTorch version.
"""
