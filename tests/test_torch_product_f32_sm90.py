"""``ops.matmul.product_f32`` on bf16 operands on the card: the autograd
Function around ``torch.mm(out_dtype=float32)`` that carries LoRA's
adapter products and QLoRA's fp32-output base products under autograd.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_product_f32_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  The reference is fp32 autograd of
the same bf16 values upcast.  Tolerances (relative L2, and the cosine
above 1 - the bar): the fp32 output within 2^-16 (fp32 summation order
alone); each input gradient within 2^-7, bf16's epsilon (the cotangent
and the gradient are each rounded to bf16 once: about 2.4e-3 expected).
Without a recorded graph the product is the same ``torch.mm`` call,
bit-equal to the Function's output.
"""

import pytest
import torch

from mjvideo_tpu_torch.ops.matmul import product_f32

FWD_REL = 2 ** -16
BWD_REL = 2 ** -7
# (x's shape, w's shape): MJ-VIDEO-2B's adapters at rank 16 (x @ a, then
# (x @ a) @ b onto the fused qkv width), a base projection, and a 3-D x.
SHAPES = (((1024, 2048), (2048, 16)), ((1024, 16), (16, 6144)),
          ((1024, 2048), (2048, 2048)), ((2, 517, 2048), (2048, 16)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (bf16 operands take torch.mm's "
                    "out_dtype path only there); run there with "
                    "--noconftest -m cuda")
    return torch.device("cuda:0")


def _rel_cos(got, ref):
    a, b = got.double().flatten(), ref.double().flatten()
    return (((a - b).norm() / b.norm()).item(),
            (a @ b / (a.norm() * b.norm())).item())


def _held(name, got, ref, bar):
    rel, cos = _rel_cos(got, ref)
    assert rel <= bar and cos >= 1 - bar, (name, rel, cos, bar)


def _operands(dev, xs, ws, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(ws, generator=g, device=dev)
         * ws[0] ** -0.5).to(torch.bfloat16)
    ct = torch.randn((*xs[:-1], ws[-1]), generator=g, device=dev)
    return x, w, ct


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws", SHAPES,
                         ids=[f"{xs}x{ws}" for xs, ws in SHAPES])
def test_product_f32_and_its_gradients_against_fp32_autograd(cuda_device,
                                                             xs, ws):
    x, w, ct = _operands(cuda_device, xs, ws, 27)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = product_f32(xb, wb)
    y.backward(ct)
    x32, w32 = x.float().requires_grad_(), w.float().requires_grad_()
    y32 = torch.matmul(x32, w32)
    y32.backward(ct)
    assert y.dtype == torch.float32 and y.shape == y32.shape
    assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    _held("y", y.detach(), y32.detach(), FWD_REL)
    _held("gx", xb.grad, x32.grad, BWD_REL)
    _held("gw", wb.grad, w32.grad, BWD_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "w"])
def test_product_f32_gradient_of_one_input(cuda_device, which):
    """A frozen base (``w`` without grad) and a frozen input (``x``
    without grad) each give the other's gradient alone, equal to the
    gradient when both are recorded."""
    x, w, ct = _operands(cuda_device, (1024, 2048), (2048, 16), 28)
    xb = x.clone().requires_grad_(which == "x")
    wb = w.clone().requires_grad_(which == "w")
    product_f32(xb, wb).backward(ct)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    product_f32(xa, wa).backward(ct)
    if which == "x":
        assert wb.grad is None and torch.equal(xb.grad, xa.grad)
    else:
        assert xb.grad is None and torch.equal(wb.grad, wa.grad)


@pytest.mark.cuda
def test_product_f32_without_a_graph_is_the_functions_forward(cuda_device):
    x, w, _ = _operands(cuda_device, (2, 517, 2048), (2048, 6144), 29)
    with torch.no_grad():
        plain = product_f32(x, w)
    recorded = product_f32(x, w.clone().requires_grad_())
    assert plain.dtype == torch.float32 and not plain.requires_grad
    assert recorded.requires_grad
    assert torch.equal(plain, recorded.detach())
