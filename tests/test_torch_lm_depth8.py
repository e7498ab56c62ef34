"""mamba2-370m's prefill-vs-decode gap at 8 layers on the CPU, port against
the JAX package (``torch_lm_parity.check_mamba2_depth_gap``); the other
depth has a file of its own, so that the two slow cases run in parallel."""
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

from torch_lm_parity import check_mamba2_depth_gap  # noqa: E402


@pytest.mark.parametrize("layers", [8])
def test_mamba2_prefill_decode_gap_at_depth_tracks_the_reference(layers):
    check_mamba2_depth_gap(layers)
