"""RewardScorer: batched, bucketed reward scoring, and the differentiable
reward of reward-feedback finetuning.

Counterpart of ``mjvideo_tpu/eval/scorer.py``.  ``score_video`` and
``score_pair`` take video files: ``prepare_clip`` decodes the frames on the
host (cv2) and either tiles and normalises them there (PIL) or, with
``device_preprocess=True``, hands the decoded uint8 frames to the device,
which resizes, tiles and normalises them (``ops/preprocess.py``) before the
forward.  ``score_batch`` splits a batch into micro-batches of
``device_batch`` clips, pads every prompt of a micro-batch to one length
bucket, guards the ``<IMG_CONTEXT>`` count against the tiles, and runs
``reward_forward`` once a micro-batch on the device that holds the
parameters.
``score_fn`` and ``score_fn_with_params`` return the score as a
differentiable function of the pixels (and the weights): the VADER-style
reward-feedback hook (SURVEY.md section 7.1 step 9), whose gradient runs
back through the reward head, the decoder (K2 with the lse, K4a, K4b), the
``<IMG_CONTEXT>`` scatter, the projector and the ViT (K1 with the lse, K4
nc), each layer rematerialised.  ``sp=`` scores long prompts
sequence-parallel (``parallel/sequence.py``), ``mesh=`` over a (data,
model) mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import RewardConfig
from ..data.prompts import (
    GATING_TOKEN_PATTERN,
    build_video_question,
    prepare_chat_input,
    rebase_img_context_id,
)

from ..models.reward import RewardOutput, reward_forward
from ..ops.quant import (
    OutlierQuantKernel,
    QuantKernel,
    quant_nodes,
    with_amax_group,
    quantize_params_mode,
)
from ..parallel.mesh import held, shard_params
from ..utils.bridge import first_tensor


def round_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


def device_grid(cfg: RewardConfig, max_num: int, width: int,
                height: int) -> Tuple[int, int]:
    """The tile grid (cols, rows) of the device preprocessing for frames of
    this resolution at ``max_num``; (1, 1) resizes each frame to one tile,
    with no thumbnail."""
    from ..data.video import select_tile_grid

    if max_num == 1:
        return (1, 1)
    return select_tile_grid(width, height, 1, max_num, cfg.chat.image_size)


def tiles_per_frame(cfg: RewardConfig, grid: Tuple[int, int]) -> int:
    """Tiles a frame makes on ``grid``: the thumbnail follows a grid of
    more than one tile."""
    n = grid[0] * grid[1]
    return n + 1 if n > 1 and cfg.chat.use_thumbnail else n


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
        device_preprocess: bool = False,
        device_max_num: int = 1,
        device_batch: Optional[int] = 8,
        mesh=None,
    ):
        """``params``: the state of ``init_reward_params``,
        ``utils.checkpoint.load_reward_model`` or
        ``utils.bridge.from_jax_params``; scoring runs on its device.
        ``dtype``: the pixel dtype (the parameters keep theirs).
        ``device_preprocess=True``: ``score_batch`` takes decoded uint8
        frames at their own resolution, which go to the device as uint8 and
        are resized, tiled and normalised there (``ops/preprocess.py``),
        in place of the host's PIL tiling and normalisation.
        ``device_max_num``: the tiling ceiling of that path; the grid is
        chosen on the host from the frames' resolution
        (``data.video.select_tile_grid``), 1 resizes each frame to one tile.
        ``device_batch``: clips per forward; a larger batch splits into
        micro-batches of this many clips, run one after another, their
        outputs concatenated.  None runs the whole batch in one forward.
        The default, 8, is the fastest setting ``chip_smoke.py`` phase 22
        measured: on an H100 (700 W), eight 8-frame 1280x720 clips on the
        frames path at ``device_max_num=1`` scored at 15.04, 15.98, 16.89
        and 17.09 clips/s with ``device_batch`` 1, 2, 4 and 8, at a peak
        memory of 4.22, 4.62, 5.44 and 7.07 GiB; larger forwards were not
        measured, so a larger batch splits.
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
        offset starts on a tile boundary.
        ``mesh`` (a ``parallel.mesh.Mesh``, JAX ``scorer.py:52-61``): the
        parameters are placed by the TP rules (``shard_params``), and
        without ``sp`` a micro-batch holds ``device_batch`` clips per data
        shard, each data shard scores its clips and the outputs come back
        gathered in clip order; a micro-batch that the data axis does not
        divide raises ``ValueError``, as JAX's ``shard_batch`` does.  Under
        ``sp`` the data axis carries the sequence
        (``mesh.sequence_group()``, unless ``sp_group`` is given) and the
        batch is not split.  An ``-olN`` state takes the whole batch's
        column amax: across processes it is max-reduced over the data
        axis; in a local mesh the data shards of a micro-batch then run in
        one forward, since that choice couples their rows."""
        if sp is not None:
            if sp not in ("ring", "allgather"):
                raise ValueError(f"unknown sp kind {sp!r}")
            if sp_group is None and mesh is not None:
                sp_group = mesh.sequence_group()
            if sp_group is None:
                raise ValueError("sp requires sp_group")
        self.sp = None if sp is None else {"group": sp_group, "kind": sp}
        self.device_preprocess = device_preprocess
        self.device_max_num = device_max_num
        self.device_batch = device_batch
        if quant is not None:
            params = quantize_params_mode(params, quant)
        self.quant = quant
        self.mesh = mesh
        self._outliers = any(isinstance(n, OutlierQuantKernel)
                             for n in quant_nodes(params))
        if mesh is not None:
            params = shard_params(params, mesh, cfg=cfg)
            if self._outliers and not mesh.is_local and mesh.data > 1:
                params = [with_amax_group(t, mesh.data_group)
                          for t in params]
        self.params = params
        self.device = first_tensor(held(params)[0]).device
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

    def _device_grid(self, width: int, height: int) -> Tuple[int, int]:
        return device_grid(self.cfg, self.device_max_num, width, height)

    def _pad(self, ids: np.ndarray, T: int, value: int) -> np.ndarray:
        out = np.full((T,), value, ids.dtype)
        out[: min(len(ids), T)] = ids[:T]
        return out

    def _micro_batch(self, B: int) -> int:
        """Clips per forward (``device_batch``, per data shard under a
        mesh without ``sp``; None: the whole batch)."""
        if self.device_batch is None:
            return B
        micro = self.device_batch
        if self.mesh is not None and self.sp is None:
            micro *= self.mesh.data
        return min(micro, B)

    def _clip_pixel_rows(self, pixel_values, input_ids_list):
        """Each clip's rows of ``pixel_values`` (tiles, or frames under
        ``device_preprocess``), from its <IMG_CONTEXT> count: clips may hold
        different numbers of tiles.  None where the rows cannot be
        attributed to the clips (the batch then runs in one forward, whose
        guard reports the mismatch)."""
        nt = self.cfg.chat.num_image_token
        if self.device_preprocess:
            h, w = pixel_values.shape[1:3]
            nt *= tiles_per_frame(self.cfg, self._device_grid(w, h))
        rows = [int((np.asarray(i) == self.img_context_token_id).sum()) // nt
                for i in input_ids_list]
        if sum(rows) != pixel_values.shape[0] or min(rows) <= 0:
            return None
        return rows

    @torch.inference_mode()
    def score_batch(
        self,
        pixel_values,  # (B*P, H, W, 3): normalized tiles, or uint8 frames
        input_ids_list: List[np.ndarray],
        gating_pos: Sequence[int],
    ) -> RewardOutput:
        """Score B clips whose tiles (or, under ``device_preprocess``,
        frames) are concatenated in order, in micro-batches of
        ``device_batch`` clips; each clip's outputs do not depend on the
        clips it is batched with."""
        B = len(input_ids_list)
        micro = self._micro_batch(B)
        if micro < B:
            rows = self._clip_pixel_rows(pixel_values, input_ids_list)
            if rows is not None:
                bounds = np.concatenate([[0], np.cumsum(rows)])
                outs = [self._forward(pixel_values[bounds[s]:bounds[e]],
                                      input_ids_list[s:e],
                                      list(gating_pos)[s:e])
                        for s, e in ((s, min(s + micro, B))
                                     for s in range(0, B, micro))]
                return RewardOutput(*(torch.cat(f, dim=0)
                                      for f in zip(*outs)))
        return self._forward(pixel_values, input_ids_list, gating_pos)

    def _forward(self, pixel_values, input_ids_list, gating_pos
                 ) -> RewardOutput:
        """One forward over the clips given (each data shard's over its
        clips under a mesh without ``sp``), every prompt padded to the
        bucket of the longest."""
        T = round_to_bucket(max(len(i) for i in input_ids_list), self.buckets)
        mesh = self.mesh
        if mesh is None or self.sp is not None or mesh.data == 1:
            return self._forward_rows(pixel_values, input_ids_list,
                                      gating_pos, T)
        B, n_data = len(input_ids_list), mesh.data
        if B % n_data:
            raise ValueError(f"{B} clips do not divide over the data axis "
                             f"({n_data})")
        rows = self._clip_pixel_rows(pixel_values, input_ids_list)
        if rows is None:
            raise ValueError("the pixel rows cannot be attributed to the "
                             "clips (their <IMG_CONTEXT> counts), so the "
                             "batch cannot be split over the data axis")
        if self._outliers and mesh.is_local:
            return self._forward_rows(pixel_values, input_ids_list,
                                      gating_pos, T)
        bounds = np.concatenate([[0], np.cumsum(rows)])
        n, gpos = B // n_data, list(gating_pos)
        outs = [self._forward_rows(
            pixel_values[bounds[d * n]:bounds[(d + 1) * n]],
            input_ids_list[d * n:(d + 1) * n], gpos[d * n:(d + 1) * n], T)
            for d in mesh.data_ranks]
        return RewardOutput(*(mesh.gather_data(list(f)) for f in zip(*outs)))

    def _forward_rows(self, pixel_values, input_ids_list, gating_pos, T
                      ) -> RewardOutput:
        """One reward forward over the clips given, padded to ``T``."""
        ids = np.stack([self._pad(np.asarray(i, np.int32), T,
                                  self.pad_token_id)
                        for i in input_ids_list])
        mask = np.stack([self._pad(np.ones(len(i), np.int32), T, 0)
                         for i in input_ids_list])
        grid, n_tiles = None, pixel_values.shape[0]
        if self.device_preprocess:
            # Decoded frames: the grid follows from their resolution.
            h, w = pixel_values.shape[1:3]
            grid = self._device_grid(w, h)
            n_tiles *= tiles_per_frame(self.cfg, grid)
        # A tokenizer/config scatter-id mismatch would silently drop the
        # image embeds and score the text alone.
        n_img = int(sum(int((np.asarray(i) == self.img_context_token_id).sum())
                        for i in input_ids_list))
        expected = n_tiles * self.cfg.chat.num_image_token
        if n_img != expected:
            raise ValueError(
                f"input_ids contain {n_img} <IMG_CONTEXT> tokens (id "
                f"{self.img_context_token_id}) but the pixel tiles produce "
                f"{expected} image embeddings — tokenizer/config mismatch "
                "or wrong num_patches_list")
        dev = self.device
        if self.device_preprocess:
            from ..ops.preprocess import (
                preprocess_frames_device,
                tile_frames_device,
            )

            frames = torch.as_tensor(pixel_values).to(dev, torch.uint8)
            size = self.cfg.chat.image_size
            if grid == (1, 1):
                pix = preprocess_frames_device(frames, size, dtype=self.dtype)
            else:
                pix = tile_frames_device(
                    frames, *grid, size, thumbnail=self.cfg.chat.use_thumbnail,
                    dtype=self.dtype)
        else:
            pix = torch.as_tensor(pixel_values).to(dev, self.dtype)
        return reward_forward(
            self.params, self.cfg, pix,
            torch.as_tensor(ids).to(dev),
            torch.as_tensor(mask).to(dev),
            torch.as_tensor(np.asarray(gating_pos, np.int32)).to(dev),
            impl=self.attn_impl,
            img_context_token_id=self.img_context_token_id,
            sp=self.sp, mesh=self.mesh,
        )

    def prepare_clip(
        self, video_path: str, caption: str,
        num_segments: int = 8, max_num: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """On the host: decode the clip's frames, tile and normalise them
        (unless ``device_preprocess``: then the decoded uint8 frames), and
        build its prompt.  Returns (pixels, input ids, gating position)."""
        from ..data.video import (
            decode_frames,
            get_frame_indices,
            load_video,
            video_metadata,
        )

        if self.device_preprocess:
            if max_num != self.device_max_num:
                raise ValueError(
                    f"device_preprocess tiles at the scorer's device_max_num"
                    f"={self.device_max_num}; got max_num={max_num} — "
                    "construct the scorer with device_max_num=max_num")
            n_frames, fps = video_metadata(video_path)
            idx = get_frame_indices(n_frames, num_segments, fps=fps)
            pixels = np.stack(decode_frames(video_path, idx))  # uint8
            grid = self._device_grid(pixels.shape[2], pixels.shape[1])
            num_patches_list = [tiles_per_frame(self.cfg, grid)] * num_segments
        else:
            pixels, num_patches_list = load_video(
                video_path, num_segments=num_segments, max_num=max_num,
                input_size=self.cfg.chat.image_size)
        question = build_video_question(caption, len(num_patches_list))
        chat = prepare_chat_input(
            self.cfg.chat, self.tokenizer, question,
            num_patches_list=num_patches_list,
            gating_pattern=self.gating_pattern)
        return pixels, chat.input_ids[0], chat.gating_pos

    @staticmethod
    def _clip_result(out: RewardOutput, b: int) -> Dict[str, np.ndarray]:
        return {name: getattr(out, name)[b].float().cpu().numpy()
                for name in ("score", "aspect_scores", "rewards")}

    def score_video(
        self, video_path: str, caption: str,
        num_segments: int = 8, max_num: int = 1,
    ) -> Dict[str, np.ndarray]:
        """(video, caption) -> {score, aspect_scores, rewards} (numpy)."""
        pixels, ids, gpos = self.prepare_clip(video_path, caption,
                                              num_segments, max_num)
        return self._clip_result(self.score_batch(pixels, [ids], [gpos]), 0)

    def score_pair(
        self, video0: str, video1: str, caption: str,
        num_segments: int = 8, max_num: int = 1,
    ) -> Tuple[Dict, Dict]:
        """Score both videos of a pair in one batch."""
        p0, i0, g0 = self.prepare_clip(video0, caption, num_segments, max_num)
        p1, i1, g1 = self.prepare_clip(video1, caption, num_segments, max_num)
        out = self.score_batch(np.concatenate([p0, p1], axis=0), [i0, i1],
                               [g0, g1])
        return self._clip_result(out, 0), self._clip_result(out, 1)

    def _differentiable_inputs(self, input_ids: np.ndarray):
        """The padded ids and mask of one clip, on the scorer's device, for
        ``score_fn``; refuses a w8a8 state."""
        if self.quant in ("int8", "int8-vit") or any(
                isinstance(n, (QuantKernel, OutlierQuantKernel))
                for n in quant_nodes(held(self.params)[0])):
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
                img_context_token_id=self.img_context_token_id, remat=True,
                mesh=self.mesh)
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
