"""Subprocess helper: `cli/train.py` of the JAX package, run as a script
(`python tests/jax_bf16_cli.py ARGS...` is `python cli/train.py ARGS...`),
with the Pallas training kernels' `lax.dot_general` upcasting bf16 ×
bf16 → f32 products' operands to f32 first.  JAX's jitted bf16 graphs
with a weight gradient stop on the CPU at such a dot of the kernels in
interpret mode ("Unsupported element type for DotThunk"); the upcast is
the same function (bf16 products are exact in f32, the accumulation is
f32 either way).  Used by tests/test_torch_bf16_train_cli.py for
`--bf16 --fused-backbone`; nothing of the JAX package changes on disk.
"""

import os
import runpy
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "cli"), REPO]

import _bootstrap  # noqa: E402,F401 — cli/'s own: JAX_PLATFORMS first

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import fastdet.kernels.fused_train as jft  # noqa: E402
import fastdet.kernels.stem_train as jst  # noqa: E402


def _dot_f32(a, b, dims, precision=None, preferred_element_type=None,
             **kw):
    if (a.dtype == jnp.bfloat16 and b.dtype == jnp.bfloat16
            and preferred_element_type == jnp.float32):
        a, b = a.astype(jnp.float32), b.astype(jnp.float32)
    return lax.dot_general(a, b, dims, precision=precision,
                           preferred_element_type=preferred_element_type,
                           **kw)


_ns = types.SimpleNamespace(**{k: getattr(lax, k) for k in dir(lax)
                               if not k.startswith("__")})
_ns.dot_general = _dot_f32
jft.lax = jst.lax = _ns

if __name__ == "__main__":
    script = os.path.join(REPO, "cli", "train.py")
    sys.argv = [script] + sys.argv[1:]
    runpy.run_path(script, run_name="__main__")
