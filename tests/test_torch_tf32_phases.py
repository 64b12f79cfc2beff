"""impx_torch/tools/tf32_phases.py's source variants, on the CPU: every
substitution applies to the kernels' sources as they stand. The builds and
readings themselves need the card."""
import pytest

from impx_torch.tools import tf32_phases as tp


@pytest.mark.parametrize("which", [tp.variants, tp.bwd_variants])
def test_every_variant_changes_the_source(which):
    """Each variant but the kernel differs from the source, and the accuracy
    mode finds each of its variants among them."""
    out = which()
    kernel = out.pop("kernel")
    assert all(srcs != kernel for srcs in out.values())
    assert set(tp.ACCURACY_VARIANTS) - {"kernel"} <= set(out)
