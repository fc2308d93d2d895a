"""RewardScorer: batched, bucketed reward scoring, and the differentiable
reward of reward-feedback finetuning.

Counterpart of ``mjvideo_tpu/eval/scorer.py`` for clips that are already
decoded and tiled: ``score_batch`` pads every prompt of a batch to one
length bucket, guards the ``<IMG_CONTEXT>`` count against the tiles, and
runs ``reward_forward`` once on the device that holds the parameters.
``score_fn`` and ``score_fn_with_params`` return the score as a
differentiable function of the pixels (and the weights): the VADER-style
reward-feedback hook (SURVEY.md section 7.1 step 9), whose gradient runs
back through the reward head, the decoder (K2 with the lse, K4a, K4b), the
``<IMG_CONTEXT>`` scatter, the projector and the ViT (K1 with the lse, K4
nc), each layer rematerialised.  ``sp=`` scores long prompts
sequence-parallel (``parallel/sequence.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import RewardConfig
from ..data.prompts import GATING_TOKEN_PATTERN, rebase_img_context_id

from ..models.reward import RewardOutput, reward_forward
from ..ops.quant import (
    OutlierQuantKernel,
    QuantKernel,
    quant_nodes,
    quantize_params_mode,
)
from ..utils.bridge import first_tensor


def round_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


class RewardScorer:
    """Scores batches of clips with one reward forward per batch."""

    def __init__(
        self,
        cfg: RewardConfig,
        params,
        tokenizer,
        dtype: torch.dtype = torch.bfloat16,
        # 2,304 = 8 frames x 256 + prompt headroom; 3,072 = the reference
        # collator ceiling.
        length_buckets: Sequence[int] = (1024, 2304, 3072),
        gating_pattern: Sequence[int] = GATING_TOKEN_PATTERN,
        attn_impl: str = "auto",
        quant: Optional[str] = None,
        sp: Optional[str] = None,
        sp_group=None,
    ):
        """``params``: the state of ``init_reward_params`` or
        ``utils.bridge.from_jax_params``; scoring runs on its device.
        ``dtype``: the pixel dtype (the parameters keep theirs).
        ``attn_impl``: "auto" (the kernels on the card) or "plain".
        ``quant``: a serving mode of ``ops.quant.quantize_params_mode``
        ("int8", "int8-noattn-g128", "int8-wo", "int4-wo", ...), applied
        to the state where it lies; a state that is already quantized is
        taken as it is.
        ``sp="ring" | "allgather"``: the decoder's attention runs
        sequence-parallel over ``sp_group`` (a
        ``parallel.sequence.SequenceGroup``), the ViT's tiles shard over it
        (JAX ``scorer.py:108-128``).  Every bucket must divide into whole
        shards; on the card each shard must also be a whole number of the
        attention kernels' 64-row tiles, so that every ring chunk and every
        offset starts on a tile boundary."""
        if sp is not None:
            if sp not in ("ring", "allgather"):
                raise ValueError(f"unknown sp kind {sp!r}")
            if sp_group is None:
                raise ValueError("sp requires sp_group")
        self.sp = None if sp is None else {"group": sp_group, "kind": sp}
        if quant is not None:
            params = quantize_params_mode(params, quant)
        self.quant = quant
        self.params = params
        self.device = first_tensor(params).device
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.buckets = tuple(length_buckets)
        self.gating_pattern = tuple(gating_pattern)
        self.attn_impl = attn_impl
        self.pad_token_id = getattr(
            tokenizer, "pad_token_id", cfg.chat.llm.pad_token_id
        ) or cfg.chat.llm.pad_token_id
        # The scatter id is the tokenizer's, as the reference assigns it at
        # load time; the config is rebased on it so every consumer agrees.
        self.cfg = rebase_img_context_id(cfg, tokenizer)
        self.img_context_token_id = self.cfg.chat.img_context_token_id
        if sp is not None:
            n = sp_group.size
            unit = n * 64 if self.device.type == "cuda" else n
            bad = [b for b in self.buckets if b % unit]
            if bad:
                raise ValueError(
                    f"sp shards the sequence over {n} shards; length buckets "
                    f"{bad} are not divisible by {unit}"
                    + (" (on the card each shard must be a whole number of "
                       "the kernels' 64-row tiles)"
                       if self.device.type == "cuda" else ""))

    def _pad(self, ids: np.ndarray, T: int, value: int) -> np.ndarray:
        out = np.full((T,), value, ids.dtype)
        out[: min(len(ids), T)] = ids[:T]
        return out

    @torch.inference_mode()
    def score_batch(
        self,
        pixel_values,  # (B*P, H, W, 3) normalized, numpy or tensor
        input_ids_list: List[np.ndarray],
        gating_pos: Sequence[int],
    ) -> RewardOutput:
        """Score B clips whose tiles are concatenated in order."""
        T = round_to_bucket(max(len(i) for i in input_ids_list), self.buckets)
        ids = np.stack([self._pad(np.asarray(i, np.int32), T,
                                  self.pad_token_id)
                        for i in input_ids_list])
        mask = np.stack([self._pad(np.ones(len(i), np.int32), T, 0)
                         for i in input_ids_list])
        # A tokenizer/config scatter-id mismatch would silently drop the
        # image embeds and score the text alone.
        n_img = int(sum(int((np.asarray(i) == self.img_context_token_id).sum())
                        for i in input_ids_list))
        expected = pixel_values.shape[0] * self.cfg.chat.num_image_token
        if n_img != expected:
            raise ValueError(
                f"input_ids contain {n_img} <IMG_CONTEXT> tokens (id "
                f"{self.img_context_token_id}) but the pixel tiles produce "
                f"{expected} image embeddings — tokenizer/config mismatch "
                "or wrong num_patches_list")
        dev = self.device
        pix = torch.as_tensor(pixel_values).to(dev, self.dtype)
        return reward_forward(
            self.params, self.cfg, pix,
            torch.as_tensor(ids).to(dev),
            torch.as_tensor(mask).to(dev),
            torch.as_tensor(np.asarray(gating_pos, np.int32)).to(dev),
            impl=self.attn_impl,
            img_context_token_id=self.img_context_token_id,
            sp=self.sp,
        )

    def _differentiable_inputs(self, input_ids: np.ndarray):
        """The padded ids and mask of one clip, on the scorer's device, for
        ``score_fn``; refuses a w8a8 state."""
        if self.quant in ("int8", "int8-vit") or any(
                isinstance(n, (QuantKernel, OutlierQuantKernel))
                for n in quant_nodes(self.params)):
            # round() in w8a8's dynamic activation quantization has zero
            # gradient: backprop to the pixels would silently return
            # zeros.  The weight-only modes ("int8-wo", "int4-wo") are
            # fine: their weights are constants and the activations stay
            # differentiable end to end.
            raise ValueError(
                "score_fn requires params without w8a8 kernels; use "
                "full-precision or a weight-only mode ('int8-wo', "
                "'int4-wo') for reward-feedback training")
        ids = np.asarray(input_ids, np.int32)
        T = round_to_bucket(len(ids), self.buckets)
        dev = self.device
        return (torch.as_tensor(self._pad(ids, T, self.pad_token_id))[None]
                .to(dev),
                torch.as_tensor(self._pad(np.ones(len(ids), np.int32), T, 0))
                [None].to(dev))

    def score_fn_with_params(self, input_ids: np.ndarray, gating_pos: int):
        """Differentiable ``(params, pixel_values) -> scalar score`` of one
        clip: ``score_fn`` with the state as an argument, so that gradients
        reach the weights the caller marks ``requires_grad``.  Layers are
        rematerialised (``remat=True``)."""
        ids, mask = self._differentiable_inputs(input_ids)
        gpos = torch.tensor([gating_pos], dtype=torch.int32, device=self.device)

        def f(params, pixel_values: torch.Tensor) -> torch.Tensor:
            out = reward_forward(
                params, self.cfg, pixel_values.to(self.dtype), ids, mask,
                gpos, impl=self.attn_impl,
                img_context_token_id=self.img_context_token_id, remat=True)
            return out.score[0]

        return f

    def score_fn(self, input_ids: np.ndarray, gating_pos: int):
        """Differentiable ``(pixel_values fp32 NHWC, on the scorer's device)
        -> scalar score`` of one clip: the reward-feedback API.  A video
        generator backprops through the whole reward stack with
        ``torch.autograd.grad(scorer.score_fn(ids, pos)(frames), frames)``.
        The prompt is padded to its bucket with the tokenizer's pad id."""
        f = self.score_fn_with_params(input_ids, gating_pos)
        return lambda pixel_values: f(self.params, pixel_values)
