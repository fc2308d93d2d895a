"""K3 not causal at the EVA2-CLIP-E tower's head dim of 112, on the CPU.

The plain twin (what the CPU path of ``exact_attention`` computes, and
what the card's kernel is held against in
``tests/test_torch_kernels_d112_sm90.py`` and ``chip_smoke.py``) against
the JAX package's Pallas kernel in interpret mode: ``_fwd_nc_impl(...,
norm_bound=False, interpret=True)``, ``_fwd_nc_kernel`` in its exact-row-max
mode, which JAX's CogVLM2 tower reaches (``cogvlm2.py:366-367``: no
``norm_bound``).  Tolerance atol 1e-5 (fp32 sums in another order; the
outputs are O(1)).  Then the route (``multi_head_attention(causal=False)``
takes K3 and no bound), the layout (D = 112 in D128's boxes: zero columns
112-127 change nothing), and the sources' and wrappers' rules.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _fwd_nc_impl
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)

D = 112
ATOL = 1e-5
# (B, S, H): the tiny tower's 17 tokens, each side of the 128-row q tile
# and 128-key tile, and a 224 px frame's 257 (the last key tile holding one
# live key).
SHAPES = {"tiny_17": (2, 17, 2), "tile_127": (1, 127, 2),
          "tile_129": (2, 129, 1), "frame_257": (1, 257, 2)}


def _qkv(case, B, S, H):
    """q, k, v with the keys' norms spread, as a post-norm tower's
    un-normalised residual stream gives them."""
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    k *= rng.uniform(0.2, 4.0, size=(B, S, H, 1)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_k3_twin_at_d112_matches_pallas_nc_kernel(case):
    q, k, v = _qkv(case, *SHAPES[case])
    ref = np.asarray(_fwd_nc_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5, None, None,
        True, False, norm_bound=False))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.exact_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    # The tower's route: the exact kernel, no bound.
    assert torch.equal(tfa.flash_attention(tq, tk, tv), got)
    assert torch.equal(multi_head_attention(tq, tk, tv, causal=False), got)


def test_k3_twin_at_d112_on_qkv_views():
    """The tower hands K3 strided views into one (B, S, 3, H, D) product;
    the twin reads them as the dense heads."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 257, 3, 2, D))
                           .astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert q.stride() == (257 * 3 * 2 * D, 3 * 2 * D, D, 1)
    got = tfa.exact_attention(q, k, v, causal=False)
    dense = tfa.exact_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=False)
    assert torch.equal(got, dense)


def test_d112_in_d128_layout_gives_zero_columns():
    """The kernel's layout on the twin: q, k and v padded with zero columns
    to 128 (TMA's zero fill of the second box past its 48 real columns),
    scale kept at 112^-0.5: the scores are unchanged, columns 112-127
    exactly 0, the first 112 the D = 112 output to 1e-6."""
    q, k, v = (torch.from_numpy(a) for a in _qkv("pad", 2, 257, 2))
    pad = [torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v)]
    wide = tfa.exact_attention_plain(*pad, scale=D ** -0.5, causal=False)
    assert not wide[..., D:].any()
    torch.testing.assert_close(
        wide[..., :D], tfa.exact_attention_plain(q, k, v, causal=False),
        atol=1e-6, rtol=0)


# --- the sources and the wrappers ----------------------------------------------

def _source(name):
    return (kernels.CSRC / name).read_text()


def test_d112_config_is_d128_s_layout_and_fits_the_card():
    """``Config<112, 2, 3>`` is D128's layout (two 64-column boxes, a
    64-float accumulator, 2 consumer warpgroups, 3 stages): its shared
    memory fits one H100 SM, q k^T takes exactly the 7 k-steps of the real
    columns (112 = 7 x 16), a row is 224 bytes (16-byte strides) and the
    epilogue stores 14 column blocks at a 112-element stride."""
    header = _source("decoder_attention_sm90.cuh")
    m = re.search(r"using D112 = Config<112, (\d+), (\d+)>;", header)
    assert m is not None
    wg, stages = map(int, m.groups())
    assert (wg, stages) == (2, 3)
    assert "D == 72 ||\n                    D == 112," in header
    boxes, block_q, block_k = (D + 63) // 64, 64 * wg, 128
    assert boxes == 2 and (D + 15) // 16 == D // 16 == 7
    assert D * 2 % 16 == 0 and 3 * 16 * D * 2 % 16 == 0
    smem = (boxes * block_q * 128 + stages * 2 * boxes * block_k * 128
            + (2 * stages + 2) * 8 + stages * 16 + 16 + 1024)
    assert smem <= 232448, smem
    assert "for (int kk = 0; kk < (C::kD + 15) / 16; ++kk) {" in header
    assert "for (int j = 0; j < C::kD / 8; ++j) {" in header
    assert "* C::kD + 2 * c;" in header


def test_exact_entry_admits_d112_not_causal_only():
    """``exact_attention.cu`` launches D112 only with ``CAUSAL = false``,
    refuses a causal call and one with the lse at 112 before any launch;
    the wrapper's rule is the same (``kernels.k3_head_dims``), and the
    backward and the lse forms keep 96 and 128."""
    exact = _source("exact_attention.cu")
    launches = [" ".join(m.split()) for m in re.findall(
        r"launch_attention<(.*?)>\(", exact, re.S)]
    assert [x for x in launches if x.startswith("D112")] == [
        "D112, false, ShiftMode::kExact"]
    branch = exact[exact.index("if (D == 112) {"):]
    branch = branch[:branch.index("\n  }\n")]
    assert "if (causal || lse != nullptr) return int(cudaErrorInvalidValue);" \
        in branch
    assert branch.index("cudaErrorInvalidValue") < branch.index(
        "launch_attention")
    assert kernels.k3_head_dims(causal=False, with_lse=False) == (96, 112,
                                                                 128)
    for causal, lse in ((True, False), (True, True), (False, True)):
        assert 112 not in kernels.k3_head_dims(causal, lse)
    assert "static_assert(D == 64 || D == 96 || D == 128" in _source(
        "attention_bwd_sm90.cuh")
    assert "D == 112" not in _source("decoder_attention.cu")
    assert "D == 112" not in _source("vit_attention.cu")


def test_headers_list_every_cuh_and_the_counter_exists():
    """The build hash covers every header (a ``.cuh`` missing from
    ``HEADERS`` would leave a stale library after an edit), and D = 112's
    launches have a counter of their own beside ``exact_attention``'s."""
    assert set(kernels.HEADERS) == {p.name for p in
                                    kernels.CSRC.glob("*.cuh")}
    assert set(kernels.SOURCES) == {p.name for p in
                                    kernels.CSRC.glob("*.cu")}
    assert {"exact_attention", "exact_attention_d112"} <= set(
        kernels.launch_counts)


def test_wrapper_refuses_a_cpu_tensor_and_the_ops_route_to_the_twin():
    """On a CPU tensor the ops compute the twin and launch nothing; the
    kernel wrapper itself refuses it (a CUDA tensor launches or raises)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv("cpu", 1, 64, 2))
    before = dict(kernels.launch_counts)
    out = tfa.exact_attention(q, k, v, causal=False)
    assert out.dtype == torch.bfloat16 and kernels.launch_counts == before
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.exact_attention(q, k, v, None, None, D ** -0.5,
                                causal=False)
