"""B1 and B2 on the Hopper forward template, on the CPU.

The card's kernels (``csrc/decoder_attention_sm90.cuh`` through
``csrc/vit_attention_variants.cu``) walk the keys once, in tiles, with a
running max and a rescale where the twins of
``ops/vit_attention_variants.py`` take every p against the row's final
max.  ``online_walk`` below repeats the kernels' walk in torch: q's fold
(``exp2`` modes), the key tiles in order (B1 128 keys, K1's Config; B2 64
at every hp, and both are tried for each), each mode's logit, the running
max, alpha, the rounding points (p to bf16 before p @ v; ``bf16s``'s t, d
and p) and l summed in fp32.  Each mode and B2 is held against its twin
to 2**-7 of max|plain|, the card's bar, at S = 37, 1025 (one key in the
last tile) and 1032, and on rows whose max arrives in the last tile about
20 nats above the rest.  The sources are
checked for the routes: B1 and B2 launch the template, no WMMA kernel is
left, and the main-path instantiations are the ones they were (K2r's now
also launched by its op).  The walk takes its keys from k, so it also
walks B3 (B2's hp 1 on the keys below ``kv_valid``:
``tests/test_torch_rows_bshd_sm90.py``).
"""

import re

import numpy as np
import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import vit_attention_variants as va

REL_TOL = 2 ** -7
LOG2E = np.float32(kernels.LOG2E)
MODES = va.VARIANT_MODES + ("exact",)  # B1's four, then B2's
TILES = (128, 64)  # B1's key tile, B2's


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def online_walk(q, k, v, mode, block_k=128, scale=None):
    """The kernels' walk of one B1 ``mode`` (or ``"exact"``, B2) over
    (B, S, H, D) q and (B, K, H, D) k/v (K = S but for B3, whose keys end
    at ``kv_valid``), in fp32 with their rounding points, tile by tile."""
    scale = np.float32(q.shape[-1] ** -0.5 if scale is None else scale)
    sl2 = float(scale * LOG2E)  # the kernel's scale * log2(e), in fp32
    qf = q.float()
    if mode in ("exp2", "exp2_nomax"):
        # The entry's fold factor, rounded to fp32 once; each product
        # rounded to bf16 in shared memory.
        qf = _bf16(qf * np.float32(float(scale) * kernels.LOG2E))
    B, S, H, D = q.shape
    m = torch.full((B, H, S, 1), -torch.inf)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, D))
    for k0 in range(0, k.shape[1], block_k):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, k0:k0 + block_k].float())
        if mode == "nomax":
            p = torch.exp2(s * sl2)
        elif mode == "exp2_nomax":
            p = torch.exp2(s)
        else:
            x = (s if mode == "exp2" else
                 _bf16(s * float(scale)) if mode == "bf16s" else s * sl2)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            if mode == "bf16s":  # nats; exp by exp2 of x log2(e)
                alpha = torch.exp2((m - m_new) * float(LOG2E))
                p = _bf16(torch.exp2(_bf16(x - m_new) * float(LOG2E)))
            else:  # log2 units
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new)
            l, o, m = l * alpha, o * alpha, m_new
        l = l + p.sum(-1, keepdim=True)
        o = o + torch.einsum("bhqk,bkhd->bhqd", _bf16(p),
                             v[:, k0:k0 + block_k].float())
    return (o / l).transpose(1, 2).to(q.dtype)


def _twin(q, k, v, mode):
    if mode == "exact":
        return va.tmajor_attention_plain(q, k, v)
    return va.variant_attention_plain(q, k, v, mode)


def _inputs(seed, S, B=1, H=2, D=64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err / want.float().abs().max().item()


@pytest.mark.parametrize("block_k", TILES)
@pytest.mark.parametrize("S", [37, 1025, 1032])
@pytest.mark.parametrize("mode", MODES)
def test_online_walk_matches_the_twin(mode, S, block_k):
    q, k, v = _inputs(S, S)
    got = online_walk(q, k, v, mode, block_k)
    rel = _rel(got, _twin(q, k, v, mode))
    assert rel <= REL_TOL, rel


def _late_max_rows(S, spread=20.0, D=64):
    """One head whose every row scores the keys before S - 1 about
    -spread / 2 nats and key S - 1 +spread / 2 (plus N(0, 0.3) noise): the
    max arrives in the last tile, about ``spread`` nats above the rest."""
    rng = np.random.default_rng(7)
    scale = D ** -0.5
    a = np.sqrt(spread / 2 / scale)  # q . k scale = +-spread / 2
    q = np.zeros((1, S, 1, D), np.float32)
    q[..., 0] = a
    q[..., 1:] = rng.normal(scale=0.3, size=(1, S, 1, D - 1))
    k = np.zeros((1, S, 1, D), np.float32)
    k[..., 0] = -a
    k[:, -1, :, 0] = a
    k[..., 1:] = rng.normal(scale=0.3, size=(1, S, 1, D - 1))
    v = rng.normal(size=(1, S, 1, D)).astype(np.float32)
    return [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]


@pytest.mark.parametrize("block_k", TILES)
@pytest.mark.parametrize("mode", MODES)
def test_online_walk_with_the_max_in_the_last_tile(mode, block_k):
    """Every earlier tile is rescaled by about e^-20 when the last one
    arrives; the result is the last key's v, as the twin's."""
    q, k, v = _late_max_rows(1025)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    spread = (s[..., -1] - s[..., :-1].amax(-1)).min().item()
    assert 15.0 < spread < 25.0, spread
    want = _twin(q, k, v, mode)
    assert (want.float() - v[:, -1:].float()).abs().max().item() < 0.02
    rel = _rel(online_walk(q, k, v, mode, block_k), want)
    assert rel <= REL_TOL, rel


def _source(name: str) -> str:
    return (kernels.CSRC / name).read_text()


def _entry(text: str, name: str) -> str:
    """The body of the C entry ``name`` of a source."""
    start = text.index(f'extern "C" int {name}(')
    end = text.find('extern "C"', start + 1)
    return text[start:end if end > 0 else len(text)]


def test_b1_and_b2_entries_launch_the_hopper_template():
    """B1's four modes and B2's three hp go through ``launch_sm90``, the
    forward template's launch_attention; no path leads to WMMA."""
    text = _source("vit_attention_variants.cu")
    assert '#include "decoder_attention_sm90.cuh"' in text
    helper = text[text.index("int launch_sm90("):]
    helper = helper[:helper.index("\n}\n")]
    assert "sm90::launch_attention<C, false, SHIFT, false, VAR>(" in helper
    b1 = _entry(text, "mjv_vit_attention_variant")
    b2 = _entry(text, "mjv_vit_attention_tmajor")
    for body, n in ((b1, len(kernels.VARIANT_MODES)),
                    (b2, len(kernels.TMAJOR_HP))):
        assert body.count("return launch_sm90<") == n
        assert "variant_attention_kernel" not in body
    for policy in ("ShiftMode::kExact, Variant::kFoldQ",
                   "ShiftMode::kExact, Variant::kBf16s",
                   "ShiftMode::kZero>", "ShiftMode::kZero, Variant::kFoldQ"):
        assert policy in b1, policy
    for hp in kernels.TMAJOR_HP:
        assert f"launch_sm90<Hp{hp}, ShiftMode::kExact>(" in b2, hp
        assert re.search(rf"^using Hp{hp} = sm90::", text, re.M), hp


def test_the_wmma_kernel_is_left_to_b3():
    """No WMMA kernel is left: ``variant_attention_kernel`` (the first
    template) and its helpers are gone, the file defines no kernel and
    launches none itself, and B3's entry reaches the forward template
    through ``launch_sm90`` as B1 and B2 do."""
    text = _source("vit_attention_variants.cu")
    b3 = _entry(text, "mjv_vit_attention_bshd")
    for gone in ("variant_attention_kernel", "stage_rows", "warp_scores",
                 "wmma", "<mma.h>", "<<<", "__global__"):
        assert gone not in text, gone
    assert "return launch_sm90<Hp1, ShiftMode::kExact>(" in b3
    assert "template <Mode" not in text and "enum class Mode" not in text


def _launches(text: str):
    return [" ".join(m.split()) for m in
            re.findall(r"launch_attention<(.*?)>\(", text, re.S)]


def test_main_path_instantiations_are_unchanged():
    """K1, K1 lse, K2, K2 lse, K2r, K3 and K3 lse launch the template as
    they did (K2r twice: alone and, as K2 does, from its op), K2, K2r and
    K3 also at Phi-3's D96 beside their D128 launches, K1 also at the
    Qwen2-VL tower's D80 and SigLIP's D72 beside its D64 ones, K1m (K2's
    masked path, not causal) at D72 alone and from its op, K3 not causal
    at the EVA2-CLIP-E tower's D112 before them, and its new
    parameters (heads a CTA, keys a tile, the softmax's Variant) default to
    what those kernels were."""
    assert _launches(_source("vit_attention.cu")) == [
        "sm90::D72, false, sm90::ShiftMode::kKeyMax, true",
        "sm90::D80, false, sm90::ShiftMode::kKeyMax, true",
        "sm90::D64, false, sm90::ShiftMode::kKeyMax, true"] * 2
    assert _launches(_source("decoder_attention.cu")) == [
        "sm90::D96, true, sm90::ShiftMode::kKeyMax",
        "sm90::D128, true, sm90::ShiftMode::kKeyMax"] * 2 + [
        "sm90::D72, false, sm90::ShiftMode::kKeyMax"] * 2 + [
        "sm90::D96, true, sm90::ShiftMode::kRows",
        "sm90::D128, true, sm90::ShiftMode::kRows"] * 2
    assert _launches(_source("exact_attention.cu")) == [
        "D112, false, ShiftMode::kExact",
        "D96, true, ShiftMode::kExact", "D96, false, ShiftMode::kExact",
        "D128, true, ShiftMode::kExact", "D128, false, ShiftMode::kExact"]
    header = _source("decoder_attention_sm90.cuh")
    assert "using D128 = Config<128, 2, 3>;" in header
    assert "using D64 = Config<64, 3, 3>;" in header
    assert "using D80 = Config<80, 2, 3>;" in header
    assert ("template <int D, int WG, int STAGES, int HP = 1, "
            "int BLOCK_K = 128>") in header
    assert header.count("Variant VAR = Variant::kPlain>") == 2
    assert "ShiftMode::kZero" in header and "kFoldQ" in header


def _config(text: str, alias: str):
    """(D, WG, STAGES, HP, BLOCK_K) of ``using <alias> = ...;``."""
    rhs = re.search(rf"^using {alias} = sm90::(\w+)(<[^>]*>)?;$", text,
                    re.M)
    if rhs.group(1) == "D64":
        return 64, 3, 3, 1, 128
    args = [int(a) for a in rhs.group(2).strip("<>").split(",")]
    return tuple(args + [1, 128][len(args) - 3:])


def test_b2_configs_walk_one_key_tile_and_fit_an_sm():
    """Every hp of B2 walks the same key tiles (so that each row's
    arithmetic, and its bits, do not depend on hp), its Config holds hp
    heads, and each Config's shared memory (the template's layout) fits
    one CTA's 232,448 bytes with the registers its warpgroups split."""
    text = _source("vit_attention_variants.cu")
    header = _source("decoder_attention_sm90.cuh")
    regs = {int(w): (int(c), int(p)) for w, c, p in re.findall(
        r"struct Regs<(\d+)> \{.*?\n\s*static constexpr int kConsumer = "
        r"(\d+), kProducer = (\d+);", header, re.S)}
    tiles = set()
    for alias in ["VariantConfig"] + [f"Hp{n}" for n in kernels.TMAJOR_HP]:
        D, WG, ST, HP, BK = _config(text, alias)
        if alias != "VariantConfig":
            assert HP == int(alias[2:]), alias
            tiles.add(BK)
        q = HP * (D // 64) * (64 * WG // HP) * 128
        stage = 2 * HP * (D // 64) * BK * 128
        smem = q + ST * stage + (2 * ST + 2) * 8 + ST * 16 + 16 + 1024
        assert smem <= 232448, (alias, smem)
        consumer, producer = regs[WG]
        # No more than 65,536 registers, and no more than the CTA holds at
        # launch (in steps of 8 a thread), or setmaxnreg.inc never returns.
        launch = (65536 // ((4 * WG + 4) * 32)) // 8 * 8
        assert 4 * WG * consumer + 4 * producer <= (4 * WG + 4) * launch
    assert len(tiles) == 1, tiles
