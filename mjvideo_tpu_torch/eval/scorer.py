"""RewardScorer: batched, bucketed reward scoring.

Counterpart of ``mjvideo_tpu/eval/scorer.py`` for clips that are already
decoded and tiled: ``score_batch`` pads every prompt of a batch to one
length bucket, guards the ``<IMG_CONTEXT>`` count against the tiles, and
runs ``reward_forward`` once on the device that holds the parameters.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mjvideo_tpu.configs import RewardConfig
from mjvideo_tpu.data.prompts import GATING_TOKEN_PATTERN, rebase_img_context_id

from ..models.reward import RewardOutput, reward_forward
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
    ):
        """``params``: the state of ``init_reward_params`` or
        ``utils.bridge.from_jax_params``; scoring runs on its device.
        ``dtype``: the pixel dtype (the parameters keep theirs).
        ``attn_impl``: "auto" (the kernels on the card) or "plain"."""
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
        )
