"""K1 on the card, held against its plain twin (K atol 3e-5, dX scaled by
max|dX| atol 5e-5, the tolerances of ``tests/test_pallas_block.py``).

These tests need a CUDA card and skip without one. The file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from sigsvgd_tpu_torch.kernels import sigkernel_block as kb
from sigsvgd_tpu_torch.kernels.sigkernel import SignatureKernel


def _assert_k_dx(K, dX, Kp, dXp):
    torch.testing.assert_close(K, Kp, atol=3e-5, rtol=0)
    scale = dXp.abs().max()
    torch.testing.assert_close(dX / scale, dXp / scale, atol=5e-5, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,C", [(1024, 40, 2), (333, 40, 2), (33, 21, 3), (7, 5, 3),
                                   (40, 64, 3)])
def test_k1_matches_plain_twin_on_the_card(cuda_device, n, L, C):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.cumsum((torch.rand((n, L, C), generator=g, device=cuda_device) - 0.5) * 0.2,
                     dim=1).contiguous()
    before = kb.block_gram_and_grad.launches
    K, dX = kb.block_gram_and_grad(X, 4.0)
    assert kb.block_gram_and_grad.launches == before + 1
    Kp, dXp = kb.block_gram_and_grad_plain(X, 4.0)
    _assert_k_dx(K.cpu(), dX.cpu(), Kp.cpu(), dXp.cpu())


@pytest.mark.cuda
def test_k1_raises_outside_its_envelope(cuda_device):
    with pytest.raises(NotImplementedError, match="K7"):
        kb.block_gram_and_grad(torch.zeros(8, 65, 2, device=cuda_device), 4.0)
    with pytest.raises(NotImplementedError, match="K2"):
        SignatureKernel(dyadic_order=3, bandwidth=4.0).gram_and_grad(
            torch.zeros(8, 40, 2, device=cuda_device))
