"""The port's state back to the reference's torch state_dict naming: the
port's ``mjvideo_tpu/utils/export.py``.

The inverse of ``utils/checkpoint.py``: weights trained or served by the
port are published in the format ``InternVLChatRewardModeling`` loads
(``criteria_train.py:370-382``) and the JAX importer reads back; a
CogVLM2-Video state under the THUDM names (``export_cogvlm2``).  The
``export_*`` functions return views of the state where they can (a
transposed kernel, a layer of a stacked leaf), in its dtype and on its
device; ``save_safetensors`` writes them as F32, as the JAX exporter
does, each made contiguous and brought to the host one at a time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from ..configs import ChatConfig, LLMConfig, RewardConfig, VisionConfig
from .safetensors_io import save_file


def _w(kernel: torch.Tensor) -> torch.Tensor:
    """kernel (in, out) -> torch Linear weight (out, in), a view."""
    return kernel.T


def pack_wqkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: LLMConfig) -> torch.Tensor:
    """q/k/v kernels (in, out) -> packed wqkv torch weight (out, in).

    Inverse of ``checkpoint.unpack_wqkv`` ('(h gs d)' layout,
    ``modeling_internlm2.py:361-371``).
    """
    Hkv, G, D = (cfg.num_key_value_heads, cfg.num_key_value_groups,
                 cfg.head_dim)
    C = q.shape[0]
    qt = _w(q).reshape(Hkv, G, D, C)
    kt = _w(k).reshape(Hkv, 1, D, C)
    vt = _w(v).reshape(Hkv, 1, D, C)
    packed = torch.cat([qt, kt, vt], dim=1)  # (Hkv, G+2, D, C)
    return packed.reshape(Hkv * (G + 2) * D, C)


def export_vit(params: Dict[str, Any], cfg: VisionConfig,
               prefix: str = "vision_model.") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    P = cfg.patch_size
    conv = emb["patch_embedding"]["kernel"].reshape(P, P, 3, -1)
    # A view in (C_out, C_in, kh, kw) order; the writer stores its values.
    out[prefix + "embeddings.patch_embedding.weight"] = conv.permute(
        3, 2, 0, 1)
    out[prefix + "embeddings.patch_embedding.bias"] = (
        emb["patch_embedding"]["bias"])
    out[prefix + "embeddings.class_embedding"] = emb["class_embedding"]
    out[prefix + "embeddings.position_embedding"] = emb["position_embedding"]
    lp = params["layers"]
    for i in range(cfg.num_hidden_layers):
        pre = f"{prefix}encoder.layers.{i}."
        out[pre + "norm1.weight"] = lp["norm1"]["weight"][i]
        out[pre + "norm2.weight"] = lp["norm2"]["weight"][i]
        if "bias" in lp["norm1"]:
            out[pre + "norm1.bias"] = lp["norm1"]["bias"][i]
            out[pre + "norm2.bias"] = lp["norm2"]["bias"][i]
        out[pre + "attn.qkv.weight"] = _w(lp["attn"]["qkv"]["kernel"][i])
        if "bias" in lp["attn"]["qkv"]:
            out[pre + "attn.qkv.bias"] = lp["attn"]["qkv"]["bias"][i]
        out[pre + "attn.proj.weight"] = _w(lp["attn"]["proj"]["kernel"][i])
        out[pre + "attn.proj.bias"] = lp["attn"]["proj"]["bias"][i]
        if "q_norm" in lp["attn"]:
            out[pre + "attn.q_norm.weight"] = lp["attn"]["q_norm"]["weight"][i]
            out[pre + "attn.k_norm.weight"] = lp["attn"]["k_norm"]["weight"][i]
        for fc in ("fc1", "fc2"):
            out[pre + f"mlp.{fc}.weight"] = _w(lp["mlp"][fc]["kernel"][i])
            out[pre + f"mlp.{fc}.bias"] = lp["mlp"][fc]["bias"][i]
        out[pre + "ls1"] = lp["ls1"][i]
        out[pre + "ls2"] = lp["ls2"][i]
    return out


def export_decoder(params: Dict[str, Any], cfg: LLMConfig,
                   prefix: str = "language_model.") -> Dict[str, torch.Tensor]:
    if cfg.architecture == "llama":
        return _export_llama(params, cfg, prefix)
    if cfg.architecture == "phi3":
        return _export_phi3(params, cfg, prefix)
    out: Dict[str, torch.Tensor] = {}
    lp = params["layers"]
    attn = lp["attention"]
    out[prefix + "model.tok_embeddings.weight"] = params["tok_embeddings"]
    for i in range(cfg.num_hidden_layers):
        pre = f"{prefix}model.layers.{i}."
        out[pre + "attention.wqkv.weight"] = pack_wqkv(
            attn["wq"]["kernel"][i], attn["wk"]["kernel"][i],
            attn["wv"]["kernel"][i], cfg)
        out[pre + "attention.wo.weight"] = _w(attn["wo"]["kernel"][i])
        if "bias" in attn["wq"]:
            out[pre + "attention.wqkv.bias"] = pack_wqkv(
                attn["wq"]["bias"][i][None], attn["wk"]["bias"][i][None],
                attn["wv"]["bias"][i][None], cfg)[:, 0]
            out[pre + "attention.wo.bias"] = attn["wo"]["bias"][i]
        out[pre + "attention_norm.weight"] = lp["attention_norm"]["weight"][i]
        out[pre + "ffn_norm.weight"] = lp["ffn_norm"]["weight"][i]
        for name in ("w1", "w2", "w3"):
            out[pre + f"feed_forward.{name}.weight"] = _w(
                lp["feed_forward"][name]["kernel"][i])
    out[prefix + "model.norm.weight"] = params["norm"]["weight"]
    if "output" in params:
        out[prefix + "output.weight"] = _w(params["output"]["kernel"])
    return out


def _export_phi3(params: Dict[str, Any], cfg: LLMConfig,
                 prefix: str) -> Dict[str, torch.Tensor]:
    """Phi-3's names (``mjvideo_tpu/utils/export.py:120-149``): q, k and v
    packed as the row blocks of ``qkv_proj``, the gate and up projections
    as those of ``gate_up_proj`` (copies: the blocks are concatenated)."""
    out: Dict[str, torch.Tensor] = {}
    lp = params["layers"]
    attn, ffn = lp["attention"], lp["feed_forward"]
    out[prefix + "model.embed_tokens.weight"] = params["tok_embeddings"]
    for i in range(cfg.num_hidden_layers):
        pre = f"{prefix}model.layers.{i}."
        out[pre + "self_attn.qkv_proj.weight"] = torch.cat(
            [_w(attn[n]["kernel"][i]) for n in ("wq", "wk", "wv")])
        out[pre + "self_attn.o_proj.weight"] = _w(attn["wo"]["kernel"][i])
        out[pre + "mlp.gate_up_proj.weight"] = torch.cat(
            [_w(ffn[n]["kernel"][i]) for n in ("w1", "w3")])
        out[pre + "mlp.down_proj.weight"] = _w(ffn["w2"]["kernel"][i])
        out[pre + "input_layernorm.weight"] = lp["attention_norm"]["weight"][i]
        out[pre + "post_attention_layernorm.weight"] = (
            lp["ffn_norm"]["weight"][i])
    out[prefix + "model.norm.weight"] = params["norm"]["weight"]
    if "output" in params:
        out[prefix + "lm_head.weight"] = _w(params["output"]["kernel"])
    return out


# The Llama layout's projections: (our node, its HF name).
_LLAMA_ATTENTION = (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                    ("wo", "o_proj"))
_LLAMA_MLP = (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj"))


def _export_llama(params: Dict[str, Any], cfg: LLMConfig,
                  prefix: str) -> Dict[str, torch.Tensor]:
    """The Llama layout's names (Mistral, Qwen2;
    ``mjvideo_tpu/utils/export.py:150-173``): separate projections, the
    LM head as ``lm_head.weight``.  Where the state has biases (Qwen2's
    q/k/v, and the o_proj bias the importer fills with zeros), they are
    written too, which the JAX exporter omits: its export of a Qwen2 state
    loses the biases."""
    out: Dict[str, torch.Tensor] = {}
    lp = params["layers"]
    attn, ffn = lp["attention"], lp["feed_forward"]
    out[prefix + "model.embed_tokens.weight"] = params["tok_embeddings"]
    for i in range(cfg.num_hidden_layers):
        pre = f"{prefix}model.layers.{i}."
        for ours, hf in _LLAMA_ATTENTION:
            out[pre + f"self_attn.{hf}.weight"] = _w(attn[ours]["kernel"][i])
            if "bias" in attn[ours]:
                out[pre + f"self_attn.{hf}.bias"] = attn[ours]["bias"][i]
        for ours, hf in _LLAMA_MLP:
            out[pre + f"mlp.{hf}.weight"] = _w(ffn[ours]["kernel"][i])
        out[pre + "input_layernorm.weight"] = lp["attention_norm"]["weight"][i]
        out[pre + "post_attention_layernorm.weight"] = (
            lp["ffn_norm"]["weight"][i])
    out[prefix + "model.norm.weight"] = params["norm"]["weight"]
    if "output" in params:
        out[prefix + "lm_head.weight"] = _w(params["output"]["kernel"])
    return out


def export_cogvlm2(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A CogVLM2-Video state (``models/cogvlm2.py``) under the THUDM names
    that ``import_cogvlm2_params`` reads, views of the state (the JAX
    package has no exporter; the tests and ``chip_smoke.py`` write
    checkpoint directories with it): ``model.vision.*`` (the patch conv
    back to (C, 3, P, P), the 2x2 ``conv`` to (C, C, 2, 2)),
    ``model.layers.{i}.*`` with the two experts' projections in the Llama
    names, ``model.embed_tokens``, ``model.norm`` and ``lm_head``."""
    vc, tc = cfg.vision, cfg.text
    P, C = vc.patch_size, vc.hidden_size
    vis, ad, lm = params["vision"], params["adapter"], params["language_model"]
    v = "model.vision."
    out: Dict[str, torch.Tensor] = {
        v + "patch_embedding.proj.weight": vis["patch_embedding"]["kernel"]
        .reshape(P, P, 3, C).permute(3, 2, 0, 1),
        v + "patch_embedding.proj.bias": vis["patch_embedding"]["bias"],
        v + "patch_embedding.cls_embedding": vis["cls_embedding"][None],
        v + "patch_embedding.position_embedding.weight":
        vis["position_embedding"],
        v + "conv.weight": ad["conv"]["kernel"].reshape(2, 2, C, -1)
        .permute(3, 2, 0, 1),
        v + "conv.bias": ad["conv"]["bias"],
        v + "linear_proj.linear_proj.weight": _w(ad["linear_proj"]["kernel"]),
        v + "linear_proj.norm1.weight": ad["norm1"]["weight"],
        v + "linear_proj.norm1.bias": ad["norm1"]["bias"],
        v + "boi": ad["boi"], v + "eoi": ad["eoi"],
        "model.embed_tokens.weight": lm["tok_embeddings"],
        "model.norm.weight": lm["norm"]["weight"],
        "lm_head.weight": _w(lm["output"]["kernel"]),
    }
    for name in ("gate_proj", "dense_h_to_4h", "dense_4h_to_h"):
        out[f"{v}linear_proj.{name}.weight"] = _w(ad[name]["kernel"])
    lp = vis["layers"]
    names = {"qkv": "attention.query_key_value", "dense": "attention.dense",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(vc.num_hidden_layers):
        pre = f"{v}transformer.layers.{i}."
        for ours, hf in (("ln1", "input_layernorm"),
                         ("ln2", "post_attention_layernorm")):
            out[f"{pre}{hf}.weight"] = lp[ours]["weight"][i]
            out[f"{pre}{hf}.bias"] = lp[ours]["bias"][i]
        for ours, hf in names.items():
            out[f"{pre}{hf}.weight"] = _w(lp[ours]["kernel"][i])
            out[f"{pre}{hf}.bias"] = lp[ours]["bias"][i]
    tl = lm["layers"]
    attn, mlp = tl["attention"], tl["mlp"]
    for i in range(tc.num_hidden_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = tl["attention_norm"]["weight"][i]
        out[pre + "post_attention_layernorm.weight"] = (
            tl["ffn_norm"]["weight"][i])
        sa = pre + "self_attn."
        out[sa + "vision_expert_query_key_value.weight"] = _w(
            attn["vision_qkv"]["kernel"][i])
        out[sa + "vision_expert_query_key_value.bias"] = (
            attn["vision_qkv"]["bias"][i])
        out[sa + "language_expert_query_key_value.weight"] = _w(
            attn["language_qkv"]["kernel"][i])
        for expert in ("vision", "language"):
            out[f"{sa}{expert}_expert_dense.weight"] = _w(
                attn[f"{expert}_dense"]["kernel"][i])
            for ours, hf in _LLAMA_MLP:
                out[f"{pre}mlp.{expert}_mlp.{hf}.weight"] = _w(
                    mlp[expert][ours]["kernel"][i])
    return out


def export_projector(params: Dict[str, Any],
                     prefix: str = "mlp1.") -> Dict[str, torch.Tensor]:
    return {
        prefix + "0.weight": params["norm"]["weight"],
        prefix + "0.bias": params["norm"]["bias"],
        prefix + "1.weight": _w(params["fc1"]["kernel"]),
        prefix + "1.bias": params["fc1"]["bias"],
        prefix + "3.weight": _w(params["fc2"]["kernel"]),
        prefix + "3.bias": params["fc2"]["bias"],
    }


def export_chat(params: Dict[str, Any], cfg: ChatConfig,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    out = export_vit(params["vision_model"], cfg.vision,
                     prefix + "vision_model.")
    out.update(export_projector(params["mlp1"], prefix + "mlp1."))
    out.update(export_decoder(params["language_model"], cfg.llm,
                              prefix + "language_model."))
    return out


def _export_gating(params: Dict[str, Any], prefix: str,
                   n_hidden: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_hidden + 1):
        out[prefix + f"layers.{i}.weight"] = _w(params[f"layer_{i}"]["kernel"])
        out[prefix + f"layers.{i}.bias"] = params[f"layer_{i}"]["bias"]
    out[prefix + "logit_scale"] = params["logit_scale"]
    return out


def export_reward_checkpoint(
    params: Dict[str, Any], cfg: RewardConfig
) -> Dict[str, torch.Tensor]:
    """Full reward state -> reference-named state dict (views of the
    state, in its dtype)."""
    out = export_chat(params["model"], cfg.chat, prefix="model.")
    out["regression_layer.weight"] = _w(params["regression_layer"]["kernel"])
    out["reward_transform_matrix"] = params["reward_transform_matrix"]
    out.update(_export_gating(params["aspect_gating"], "aspect_gating.",
                              cfg.gating_n_hidden))
    out.update(_export_gating(params["criteria_gating"], "criteria_gating.",
                              cfg.gating_n_hidden))
    return out


def save_safetensors(state: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``state`` as one F32 safetensors file, as the JAX exporter
    does.  Each tensor's values are written in row-major order whatever
    its strides: the transposed patch-conv view of ``export_vit`` written
    in its storage's order once corrupted that tensor on reload
    (``tests/test_checkpoint.py:226-253``)."""
    save_file(state, path, dtype=torch.float32)


def save_reward_checkpoint_dir(path: str, params, cfg: RewardConfig) -> None:
    """Write an HF-format checkpoint directory (model.safetensors +
    config.json) that ``utils.checkpoint.load_reward_model``, the JAX
    package's loader and the reference's ``from_pretrained`` read back."""
    from ..configs import reward_config_to_hf

    os.makedirs(path, exist_ok=True)
    save_safetensors(export_reward_checkpoint(params, cfg),
                     os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(reward_config_to_hf(cfg), f, indent=2)
