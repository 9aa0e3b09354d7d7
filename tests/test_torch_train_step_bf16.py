"""One bfloat16 train step of the port against the JAX package's, run op by
op (``_torch_lm_ref``'s bfloat16 reference), for every arch at
``reduced_config``.  Tolerances: ``tests/_torch_train_ref.py``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_ref import check_step  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_equal_jax_bfloat16(arch):
    new, _ = check_step(arch, "bfloat16")
    assert new["params"]["embed"]["w"].dtype == torch.bfloat16
    assert new["opt"]["master"]["embed"]["w"].dtype == torch.float32
