"""`python -m fastdet_torch.cli.train --bf16 --fused-backbone` against
the JAX package's `cli/train.py --bf16 --fused-backbone` on the CPU (the
JAX CLI through tests/jax_bf16_cli.py), with
tests/test_torch_bf16_train_cli.py's set, checks and bounds.
"""

from test_torch_bf16_train_cli import _check
from test_torch_train_cli import train_world  # noqa: F401


def test_train_cli_bf16_fused_backbone_matches_jax(train_world, tmp_path):
    _check(train_world, tmp_path, "--fused-backbone")
