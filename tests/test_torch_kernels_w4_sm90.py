"""K5, the int4 weight-only GEMV, on the card, against its plain twin.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_w4_sm90.py --noconftest \\
        -m cuda -q

Without a card every test here skips.  Tolerance: KERNEL_REL of max|plain|.
Kernel and twin dequantize each weight to the same bf16 value and their
bf16 x bf16 products are exact, so they differ only in the order (and the
tensor cores' rounding) of the fp32 sums; 2^-10 is 8 times tighter than
``chip_smoke.py``'s 2^-7 and far below any misplaced weight, scale or k.
"""

import re

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import quant as q8
from mjvideo_tpu_torch.ops import quant4 as q4

KERNEL_REL = 2.0 ** -10
SOURCE = (kernels.CSRC / "w4_matmul.cu").read_text()
BN = int(re.search(r"using W4 = Config<(\d+),", SOURCE).group(1))
BN_WIDE = int(re.search(r"using W4Wide = Config<(\d+),", SOURCE).group(1))

# (M, K, N, g): M on each side of the 8-row tiles up to 32; N at each
# Config's BN - 1, BN and BN + 1 and odd; g of 16-128; K/2 of 5 k-blocks
# (320: the cluster's split leaves a short last slice) and not a whole
# number of k-blocks (336, 1,040); the 2B's decode shapes at a small N.
EDGES = [
    (1, 640, BN - 1, 64), (2, 640, BN, 32), (3, 672, BN + 1, 16),
    (8, 2048, 1024, 128), (16, 2080, 2 * BN + 3, 16), (17, 8192, 257, 128),
    (32, 2048, 2048, 128), (32, 640, BN_WIDE - 1, 64),
    (24, 672, BN_WIDE + 1, 16), (32, 640, 77, 64), (2, 2048, 1, 128),
    (1, 8192, 2048, 128), (2, 2048, 92553, 128),
]
# Shapes the tensor-core path does not take: g of 8 (not a multiple of 16)
# and K/2 = 40 (not a multiple of 16); the generic path in the same entry.
GENERIC = [(2, 256, 129, 8), (17, 80, 33, 40), (32, 512, 65, 8)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _operands(dev, M, K, N, g, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    k4 = q4.quantize_kernel_q4(w, group_size=g)
    assert q8.is_k_major(k4.packed)
    return x, k4


def _held(got, ref):
    err = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= KERNEL_REL * top, (err, top)


def _c_entry(x, k4, out):
    M, K = x.shape
    N, G = k4.packed.shape[1], k4.scale.shape[0]
    lib = kernels._load()
    err = lib.mjv_w4_matmul(x.data_ptr(), k4.packed.data_ptr(),
                            k4.scale.data_ptr(), out.data_ptr(), M, N, K, G,
                            torch.cuda.current_stream().cuda_stream)
    assert err == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", EDGES + GENERIC)
def test_k5_matches_its_twin_and_repeats_bit_for_bit(cuda_device, M, K, N, g):
    x, k4 = _operands(cuda_device, M, K, N, g, M * K + N)
    plan = kernels.w4_plan(M, N, K, K // g)
    assert plan["fast"] == int((M, K, N, g) not in GENERIC)
    before = kernels.launch_counts["w4_matmul"]
    got = kernels.w4_matmul(x, k4.packed, k4.scale)
    again = kernels.w4_matmul(x, k4.packed, k4.scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts["w4_matmul"] == before + 2
    _held(got, q4.w4_matmul_plain(x, k4.packed, k4.scale))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", [(2, 640, BN + 1, 32), (32, 2048, 1024,
                                                            128),
                                     (17, 80, 33, 40)])
def test_k5_writes_every_output_element(cuda_device, M, K, N, g):
    """The C entry on a NaN-filled output: no element is left unwritten (no
    memset is needed), on a cluster split, at an N tail and on the generic
    path."""
    x, k4 = _operands(cuda_device, M, K, N, g, 7 + M)
    out = torch.full((M, N), float("nan"), device=cuda_device)
    _c_entry(x, k4, out)
    torch.cuda.synchronize()
    _held(out, q4.w4_matmul_plain(x, k4.packed, k4.scale))


@pytest.mark.cuda
def test_k5_splits_k_over_a_cluster_where_the_columns_are_few(cuda_device):
    """The 2B's wk/wv (N = 1,024) and w2 (K = 8,192) split K over a
    cluster; the LM head's 92,553 columns do not; x or the packed weight
    off 16 bytes takes the generic path, with the same values."""
    assert kernels.w4_plan(2, 1024, 2048, 16)["cluster"] > 1
    assert kernels.w4_plan(2, 2048, 8192, 64)["cluster"] > 1
    assert kernels.w4_plan(2, 92553, 2048, 16)["cluster"] == 1
    x, k4 = _operands(cuda_device, 3, 2048, 1024, 128, 5)
    want = q4.w4_matmul_plain(x, k4.packed, k4.scale)
    # A view of x starting 8 bytes in.
    xs = torch.empty((3 * 2048 + 4,), dtype=torch.bfloat16,
                     device=cuda_device)[4:].view(3, 2048)
    xs.copy_(x)
    _held(kernels.w4_matmul(xs, k4.packed, k4.scale), want)
    # A k-major packed weight starting 4 bytes in.
    ps = torch.empty((1024 * 1024 + 4,), dtype=torch.int8,
                     device=cuda_device)[4:].view(1024, 1024).t()
    ps.copy_(k4.packed)
    assert q8.is_k_major(ps)
    _held(kernels.w4_matmul(x, ps, k4.scale), want)


@pytest.mark.cuda
def test_k5_refuses_a_row_major_packed_weight_on_the_card(cuda_device):
    x, k4 = _operands(cuda_device, 2, 256, 64, 32, 3)
    before = kernels.launch_counts["w4_matmul"]
    with pytest.raises(ValueError, match="k-major"):
        kernels.w4_matmul(x, k4.packed.contiguous(), k4.scale)
    with pytest.raises(ValueError, match="k-major"):
        q4.w4_matmul(x, k4.packed.contiguous(), k4.scale)
    assert kernels.launch_counts["w4_matmul"] == before
