"""Where a run may write, and which modules it may not load.

The benchmark writes only inside its checkout (the kernel build cache,
``build/kernels``, where the program's builder puts it, and
``build/bench_cache`` for the library caches below), under ``TMPDIR`` and
under ``HOME``/``XDG_CACHE_HOME``. Each cache directory is a fixed path
inside the checkout, so the second run of a cell finds what the first
built.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "bench_cache"
# top-level module names that must not be loaded by a run: the JAX
# package the program was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "daft_exprt_tpu")


def setup_environment():
    """Fix the cache directories of the libraries the program may use, and
    keep ``transformers``-style libraries off JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden, compared
    whole (``daft_exprt_tpu_torch`` is not ``daft_exprt_tpu``)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def scratch_dir() -> Path:
    """A directory of this run under ``TMPDIR`` for the files an entry
    point reads (checkpoints, the style bank, the vocoder)."""
    import tempfile
    return Path(tempfile.mkdtemp(prefix="perfbench-"))
