"""The HF-format checkpoint importer: the port's ``mjvideo_tpu/utils/checkpoint.py``.

Maps the reference's published parameter names onto the port's state, leaf
by leaf the layout of ``from_jax_params`` of the JAX importer's tree:

* ``vision_model.*``           (``modeling_intern_vit.py``)
* ``language_model.*``         (``modeling_internlm2.py``: the packed
  ``wqkv`` of grouped layout '(h gs d)', gs = 2 + groups,
  ``:301-305,361-371``, unpacked once here into q/k/v kernels; Phi-3's
  ``qkv_proj`` and ``gate_up_proj``, row blocks unpacked the same way; or
  the Llama layout's separate projections, with Qwen2's q/k/v biases)
* a SigLIP vision tower (``import_siglip_vision``: VideoScore's
  ``vision_model.*``, MiniCPM-V's ``vpm.*``)
* ``mlp1.{0,1,3}.*``           (``modeling_internvl_chat.py:135-140``)
* ``regression_layer`` / ``reward_transform_matrix`` / ``aspect_gating`` /
  ``criteria_gating``          (``moe_reward.py:137-181``)

Torch ``nn.Linear`` weights are (out, in) and become (in, out) kernels;
per-layer tensors stack on a leading L axis.  The files are read with the
port's own safetensors reader (``utils/safetensors_io.py``), and each leaf
is moved to the device as it is converted: the stacked leaf is allocated
there in its final dtype and filled one layer at a time, so no second copy
of the whole state is built on the host or in fp32.  The
port resumes its own ``torch.save`` checkpoints
(``train/trainer.py``) in place of JAX's orbax ones: ``save_state`` writes
one, blocking or in the background (JAX's ``save_pytree(block=False)``),
and ``wait_for_saves`` waits for the one outstanding.  A kernel node
(quantized, ``ops/quant*.py``, or LoRA, ``ops/lora.py``) is written as a
plain dict of its tensor fields, so the file holds dicts, tensors and
numbers only and ``torch.load(..., weights_only=True)`` reads it;
``load_state`` reads it so and revives the LoRA nodes, then the quantized
ones, as JAX's ``restore_pytree`` does (``checkpoint.py:586-604``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..configs import ChatConfig, LLMConfig, RewardConfig, VisionConfig
from .safetensors_io import load_file

Device = Union[str, torch.device]


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the ``*.safetensors`` files of a directory (or of one
    file), as CPU tensors over mmaps of the files."""
    if os.path.isdir(path):
        files: List[str] = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".safetensors"))
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no safetensors found at {path}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    return state


class _Importer:
    """Reads named tensors of ``state`` under ``prefix`` and builds leaves
    on ``device`` in ``dtype``."""

    def __init__(self, state, prefix: str, dtype: torch.dtype,
                 device: Device):
        self.state, self.prefix = state, prefix
        self.dtype, self.device = dtype, torch.device(device)

    def get(self, name: str) -> torch.Tensor:
        """The named tensor, moved to the device as it is on disk."""
        return self.state[self.prefix + name].to(self.device)

    def leaf(self, name: str) -> torch.Tensor:
        return self.get(name).to(self.dtype)

    def kernel(self, name: str) -> torch.Tensor:
        """torch Linear weight (out, in) -> kernel (in, out)."""
        return self.get(name).T.contiguous().to(self.dtype)

    def stacked(self, names: List[str],
                fn: Callable[[torch.Tensor], torch.Tensor] = lambda t: t):
        """``fn`` of each named tensor, stacked on a leading axis in place."""
        first = fn(self.get(names[0]))
        out = torch.empty((len(names),) + tuple(first.shape),
                          dtype=self.dtype, device=self.device)
        out[0].copy_(first)
        for i, name in enumerate(names[1:], 1):
            out[i].copy_(fn(self.get(name)))
        return out

    def per_layer(self, L: int, name: str, transpose: bool = False):
        return self.stacked([name.format(i) for i in range(L)],
                            (lambda t: t.T) if transpose else (lambda t: t))


def import_vit_params(
    state: Dict[str, torch.Tensor], cfg: VisionConfig,
    dtype: torch.dtype = torch.float32, prefix: str = "vision_model.",
    device: Device = "cuda",
) -> Dict[str, Any]:
    """InternViT torch names -> the port's stacked-layer ViT state."""
    im = _Importer(state, prefix, dtype, device)
    L, P = cfg.num_hidden_layers, cfg.patch_size

    def per_layer(name, transpose=False):
        return im.per_layer(L, "encoder.layers.{}." + name, transpose)

    # Conv2d (C_out, C_in, kh, kw) -> (kh*kw*C_in, C_out), the patch
    # embedding's (ph, pw, channel) flattening.
    conv = im.get("embeddings.patch_embedding.weight")
    conv = conv.permute(2, 3, 1, 0).reshape(P * P * 3, -1).to(dtype)
    layers: Dict[str, Any] = {
        "norm1": {"weight": per_layer("norm1.weight")},
        "norm2": {"weight": per_layer("norm2.weight")},
        "attn": {
            "qkv": {"kernel": per_layer("attn.qkv.weight", True)},
            "proj": {"kernel": per_layer("attn.proj.weight", True),
                     "bias": per_layer("attn.proj.bias")},
        },
        "mlp": {
            "fc1": {"kernel": per_layer("mlp.fc1.weight", True),
                    "bias": per_layer("mlp.fc1.bias")},
            "fc2": {"kernel": per_layer("mlp.fc2.weight", True),
                    "bias": per_layer("mlp.fc2.bias")},
        },
        "ls1": per_layer("ls1"),
        "ls2": per_layer("ls2"),
    }
    if cfg.norm_type != "rms_norm":
        layers["norm1"]["bias"] = per_layer("norm1.bias")
        layers["norm2"]["bias"] = per_layer("norm2.bias")
    if cfg.qkv_bias:
        layers["attn"]["qkv"]["bias"] = per_layer("attn.qkv.bias")
    if cfg.qk_normalization:
        layers["attn"]["q_norm"] = {"weight": per_layer("attn.q_norm.weight")}
        layers["attn"]["k_norm"] = {"weight": per_layer("attn.k_norm.weight")}
    return {
        "embeddings": {
            "class_embedding": im.leaf("embeddings.class_embedding"),
            "patch_embedding": {
                "kernel": conv,
                "bias": im.leaf("embeddings.patch_embedding.bias"),
            },
            "position_embedding": im.leaf("embeddings.position_embedding"),
        },
        "layers": layers,
    }


def unpack_wqkv(w: torch.Tensor, cfg: LLMConfig) -> Dict[str, torch.Tensor]:
    """Split a packed wqkv weight (out, in) into q/k/v kernels (in, out),
    views of ``w``.

    Layout per ``modeling_internlm2.py:361-371``: out dim = (h, gs, d) with
    h = num_key_value_heads, gs = 2 + groups; slots [0..G) are q heads,
    slot -2 is k, slot -1 is v.
    """
    Hkv, G, D = (cfg.num_key_value_heads, cfg.num_key_value_groups,
                 cfg.head_dim)
    C = w.shape[1]
    w = w.reshape(Hkv, G + 2, D, C)
    q = w[:, :G].reshape(Hkv * G * D, C)
    k = w[:, -2].reshape(Hkv * D, C)
    v = w[:, -1].reshape(Hkv * D, C)
    return {"q": q.T, "k": k.T, "v": v.T}


def _internlm2_layers(im: _Importer, cfg: LLMConfig) -> Dict[str, Any]:
    """The stacked layers of InternLM2's names."""
    L = cfg.num_hidden_layers

    def per_layer(name, transpose=False):
        return im.per_layer(L, "model.layers.{}." + name, transpose)

    def wqkv(part, suffix="weight"):
        names = [f"model.layers.{i}.attention.wqkv.{suffix}" for i in range(L)]
        if suffix == "weight":
            return im.stacked(names, lambda w: unpack_wqkv(w, cfg)[part])
        # The packed bias splits as the weight does.
        return im.stacked(names,
                          lambda b: unpack_wqkv(b[:, None], cfg)[part][0])

    attn = {name: {"kernel": wqkv(part)}
            for name, part in (("wq", "q"), ("wk", "k"), ("wv", "v"))}
    attn["wo"] = {"kernel": per_layer("attention.wo.weight", True)}
    if cfg.bias:
        for name, part in (("wq", "q"), ("wk", "k"), ("wv", "v")):
            attn[name]["bias"] = wqkv(part, "bias")
        attn["wo"]["bias"] = per_layer("attention.wo.bias")
    return {
        "attention_norm": {"weight": per_layer("attention_norm.weight")},
        "attention": attn,
        "ffn_norm": {"weight": per_layer("ffn_norm.weight")},
        "feed_forward": {
            name: {"kernel": per_layer(f"feed_forward.{name}.weight", True)}
            for name in ("w1", "w3", "w2")},
    }


def _phi3_layers(im: _Importer, cfg: LLMConfig) -> Dict[str, Any]:
    """The stacked layers of Phi-3's names (``mjvideo_tpu/utils/
    checkpoint.py:374-435``): ``self_attn.qkv_proj`` packs [q (Hq D); k
    (Hkv D); v (Hkv D)] rows and ``mlp.gate_up_proj`` [gate (I); up (I)]
    rows, each unpacked here into its kernels."""
    L = cfg.num_hidden_layers
    Hq, Hkv, D, I = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.intermediate_size)

    def per_layer(name, transpose=False):
        return im.per_layer(L, "model.layers.{}." + name, transpose)

    def rows(name, lo, hi):
        names = [f"model.layers.{i}.{name}" for i in range(L)]
        return {"kernel": im.stacked(names, lambda w: w[lo:hi].T)}

    qkv = "self_attn.qkv_proj.weight"
    return {
        "attention_norm": {"weight": per_layer("input_layernorm.weight")},
        "attention": {
            "wq": rows(qkv, 0, Hq * D),
            "wk": rows(qkv, Hq * D, (Hq + Hkv) * D),
            "wv": rows(qkv, (Hq + Hkv) * D, (Hq + 2 * Hkv) * D),
            "wo": {"kernel": per_layer("self_attn.o_proj.weight", True)},
        },
        "ffn_norm": {
            "weight": per_layer("post_attention_layernorm.weight")},
        "feed_forward": {
            "w1": rows("mlp.gate_up_proj.weight", 0, I),
            "w3": rows("mlp.gate_up_proj.weight", I, 2 * I),
            "w2": {"kernel": per_layer("mlp.down_proj.weight", True)},
        },
    }


def _llama_layers(im: _Importer, cfg: LLMConfig) -> Dict[str, Any]:
    """The stacked layers of the Llama layout's names (Mistral, Qwen2;
    ``mjvideo_tpu/utils/checkpoint.py:163-196, 339-355``): separate
    ``self_attn.{q,k,v,o}_proj`` and ``mlp.{gate,up,down}_proj``.  With
    ``cfg.bias`` (Qwen2) the q/k/v biases are read and must be there; the
    o_proj bias, which Qwen2 lacks, is zero where a layer has none."""
    L = cfg.num_hidden_layers

    def per_layer(name, transpose=False):
        return im.per_layer(L, "model.layers.{}." + name, transpose)

    attn = {ours: {"kernel": per_layer(f"self_attn.{hf}.weight", True)}
            for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj"))}
    if cfg.bias:
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj")):
            attn[ours]["bias"] = per_layer(f"self_attn.{hf}.bias")
        o_bias = torch.zeros((L, cfg.hidden_size), dtype=im.dtype,
                             device=im.device)
        for i in range(L):
            name = f"model.layers.{i}.self_attn.o_proj.bias"
            if im.prefix + name in im.state:
                o_bias[i].copy_(im.get(name))
        attn["wo"]["bias"] = o_bias
    return {
        "attention_norm": {"weight": per_layer("input_layernorm.weight")},
        "attention": attn,
        "ffn_norm": {
            "weight": per_layer("post_attention_layernorm.weight")},
        "feed_forward": {
            ours: {"kernel": per_layer(f"mlp.{hf}.weight", True)}
            for ours, hf in (("w1", "gate_proj"), ("w3", "up_proj"),
                             ("w2", "down_proj"))},
    }


# Per decoder layout: its layers' reader, then the names of the token
# embedding and of the LM head.
_DECODER_LAYOUTS = {
    "llama": (_llama_layers, "model.embed_tokens.weight", "lm_head.weight"),
    "internlm2": (_internlm2_layers, "model.tok_embeddings.weight",
                  "output.weight"),
    "phi3": (_phi3_layers, "model.embed_tokens.weight", "lm_head.weight"),
}


def import_decoder_params(
    state: Dict[str, torch.Tensor], cfg: LLMConfig,
    dtype: torch.dtype = torch.float32, prefix: str = "language_model.",
    with_lm_head: bool = True, device: Device = "cuda",
) -> Dict[str, Any]:
    """InternLM2, Phi-3 or Llama-layout torch names -> the port's
    stacked-layer decoder state (the same leaves for all: the layer is
    shared)."""
    if cfg.architecture not in _DECODER_LAYOUTS:
        raise ValueError(f"unknown architecture {cfg.architecture!r}")
    layers, embed, head = _DECODER_LAYOUTS[cfg.architecture]
    im = _Importer(state, prefix, dtype, device)
    params: Dict[str, Any] = {
        "tok_embeddings": im.leaf(embed),
        "layers": layers(im, cfg),
        "norm": {"weight": im.leaf("model.norm.weight")},
    }
    if with_lm_head:
        key = prefix + head
        if key not in state:
            # Fail here, not deep inside generation: a mis-prefixed or
            # truncated checkpoint must not load without its LM head.
            raise KeyError(
                f"with_lm_head=True but {key!r} is not in the checkpoint "
                f"({len(state)} tensors, prefix {prefix!r}); pass "
                "with_lm_head=False for score-only trees, or check the "
                "prefix")
        params["output"] = {"kernel": im.kernel(head)}
    return params


def import_siglip_vision(
    state: Dict[str, torch.Tensor], cfg, dtype: torch.dtype = torch.float32,
    prefix: str = "vision_model.", device: Device = "cuda",
) -> Dict[str, Any]:
    """A SigLIP vision tower's torch names -> the port's stacked-layer
    state (``mjvideo_tpu/utils/checkpoint.py:199-255``): VideoScore's
    Idefics2 tower (prefix ``vision_model.``) and MiniCPM-V-2.6's NaViT
    SigLIP (``vpm.``), the same so400m architecture.  ``cfg`` is a
    ``models.videoscore.SigLIPVisionConfig``."""
    im = _Importer(state, prefix, dtype, device)
    L, P = cfg.num_hidden_layers, cfg.patch_size

    def per_layer(name, transpose=False):
        return im.per_layer(L, "encoder.layers.{}." + name, transpose)

    def linear(hf):
        return {"kernel": per_layer(f"{hf}.weight", True),
                "bias": per_layer(f"{hf}.bias")}

    conv = im.get("embeddings.patch_embedding.weight")
    conv = conv.permute(2, 3, 1, 0).reshape(P * P * 3, -1).to(dtype)
    return {
        "patch_embedding": {
            "kernel": conv,
            "bias": im.leaf("embeddings.patch_embedding.bias"),
        },
        "position_embedding": im.leaf(
            "embeddings.position_embedding.weight"),
        "layers": {
            "ln1": {"weight": per_layer("layer_norm1.weight"),
                    "bias": per_layer("layer_norm1.bias")},
            "ln2": {"weight": per_layer("layer_norm2.weight"),
                    "bias": per_layer("layer_norm2.bias")},
            "q": linear("self_attn.q_proj"),
            "k": linear("self_attn.k_proj"),
            "v": linear("self_attn.v_proj"),
            "o": linear("self_attn.out_proj"),
            "fc1": linear("mlp.fc1"),
            "fc2": linear("mlp.fc2"),
        },
        "post_layernorm": {"weight": im.leaf("post_layernorm.weight"),
                           "bias": im.leaf("post_layernorm.bias")},
    }


def import_projector_params(
    state: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32,
    prefix: str = "mlp1.", device: Device = "cuda",
) -> Dict[str, Any]:
    """mlp1 Sequential: 0=LayerNorm, 1=Linear, 3=Linear
    (``modeling_internvl_chat.py:135-140``)."""
    im = _Importer(state, prefix, dtype, device)
    return {
        "norm": {"weight": im.leaf("0.weight"), "bias": im.leaf("0.bias")},
        "fc1": {"kernel": im.kernel("1.weight"), "bias": im.leaf("1.bias")},
        "fc2": {"kernel": im.kernel("3.weight"), "bias": im.leaf("3.bias")},
    }


def import_chat_params(
    state: Dict[str, torch.Tensor], cfg: ChatConfig,
    dtype: torch.dtype = torch.float32, prefix: str = "",
    with_lm_head: bool = True, device: Device = "cuda",
) -> Dict[str, Any]:
    return {
        "vision_model": import_vit_params(
            state, cfg.vision, dtype, prefix + "vision_model.", device),
        "mlp1": import_projector_params(state, dtype, prefix + "mlp1.",
                                        device),
        "language_model": import_decoder_params(
            state, cfg.llm, dtype, prefix + "language_model.",
            with_lm_head=with_lm_head, device=device),
    }


def _import_gating(state, dtype, prefix: str, n_hidden: int,
                   device: Device) -> Dict[str, Any]:
    """GatingNetwork: layers.{i}.weight/bias ModuleList + logit_scale
    (``moe_reward.py:16-27``)."""
    im = _Importer(state, prefix, dtype, device)
    p: Dict[str, Any] = {
        f"layer_{i}": {"kernel": im.kernel(f"layers.{i}.weight"),
                       "bias": im.leaf(f"layers.{i}.bias")}
        for i in range(n_hidden + 1)}
    p["logit_scale"] = im.leaf("logit_scale")
    return p


def import_reward_checkpoint(
    state: Dict[str, torch.Tensor], cfg: RewardConfig,
    dtype: torch.dtype = torch.float32, device: Device = "cuda",
) -> Dict[str, Any]:
    """Full InternVLChatRewardModeling state_dict -> reward state.

    The backbone lives under the ``model.`` prefix (``moe_reward.py:142``);
    the reward head at top level.  The reward path never uses the LM head,
    so ``output.weight`` is skipped if present.
    """
    im = _Importer(state, "", dtype, device)
    return {
        "model": import_chat_params(state, cfg.chat, dtype, prefix="model.",
                                    with_lm_head=False, device=device),
        "regression_layer": {"kernel": im.kernel("regression_layer.weight")},
        "reward_transform_matrix": im.leaf("reward_transform_matrix"),
        "aspect_gating": _import_gating(state, dtype, "aspect_gating.",
                                        cfg.gating_n_hidden, device),
        "criteria_gating": _import_gating(state, dtype, "criteria_gating.",
                                          cfg.gating_n_hidden, device),
    }


def load_reward_model(
    checkpoint_path: str, cfg: Optional[RewardConfig] = None,
    dtype: torch.dtype = torch.bfloat16, device: Device = "cuda",
):
    """An HF checkpoint directory (``config.json`` and safetensors) ->
    (cfg, state on ``device`` in ``dtype``)."""
    from ..configs import load_config

    if cfg is None:
        cfg = load_config(os.path.join(checkpoint_path, "config.json"))
    state = load_safetensors_dir(checkpoint_path)
    return cfg, import_reward_checkpoint(state, cfg, dtype, device)


# --- the trainer's checkpoints ----------------------------------------------


class _Writer(threading.Thread):
    """One background save; its error, if any, is raised by
    ``wait_for_saves``.  Not a daemon: the interpreter waits for it at
    exit, so a save is never left torn."""

    def __init__(self, state, path: str):
        super().__init__(name=f"save {os.path.basename(path)}")
        self.state, self.path = state, path
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            _write(self.state, self.path)
        except BaseException as e:  # raised again in the caller's thread
            self.error = e


_PENDING: Optional[_Writer] = None


def _plain_state(state):
    """``state`` with every kernel node as a plain dict of its tensor
    fields (recursively: a LoRA node's quantized ``w`` too); what
    ``save_state`` writes."""
    from .bridge import is_node, node_fields

    if isinstance(state, dict):
        return {k: _plain_state(v) for k, v in state.items()}
    if is_node(state):
        return {name: _plain_state(v) for name, v in node_fields(state)}
    return state


def _write(state, path: str) -> None:
    """``torch.save`` of ``_plain_state(state)`` through a temporary file
    and ``os.replace``: a reader sees the old file or the whole new one."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_plain_state(state), tmp)
    os.replace(tmp, path)


def host_snapshot(state):
    """A copy of ``state`` (nested dicts and kernel nodes) with every
    tensor, a node's fields included, copied to host memory (strides
    kept) and other leaves as they are: what a background save writes
    while the training step goes on updating the live tensors in place."""
    from .bridge import map_state

    return map_state(lambda x: x.detach().to("cpu", copy=True)
                     if torch.is_tensor(x) else x, state)


def save_state(state, path: str, block: bool = True) -> None:
    """Write ``state`` to ``path`` (``torch.save`` of ``_plain_state``,
    atomically).  ``block=False``: wait for the previous background save,
    take a host snapshot, and write it on a thread, so at most one save is
    outstanding; the call returns once the snapshot is taken."""
    global _PENDING
    if block:
        _write(state, path)
        return
    wait_for_saves()
    _PENDING = _Writer(host_snapshot(state), path)
    _PENDING.start()


def load_state(path: str, map_location=None):
    """A state written by ``save_state``, read with
    ``torch.load(weights_only=True)`` onto ``map_location``, its LoRA nodes
    and then its quantized nodes revived (``ops.lora.revive_lora_kernels``,
    ``ops.quant.revive_quant_kernels``; the int8 fields k-major)."""
    from ..ops.lora import revive_lora_kernels
    from ..ops.quant import revive_quant_kernels

    tree = torch.load(path, map_location=map_location, weights_only=True)
    return revive_quant_kernels(revive_lora_kernels(tree))


def wait_for_saves() -> None:
    """Block until the outstanding background save (if any) has been
    written; raise its error if it failed."""
    global _PENDING
    writer, _PENDING = _PENDING, None
    if writer is not None:
        writer.join()
        if writer.error is not None:
            raise writer.error
