"""The pairwise preference dataset, static-shape batch collation and the
host pipeline: the port's own copy of ``mjvideo_tpu/data/dataset.py``.

Replaces ``VideoDataset`` (``scripts/data_processor/dataset.py:270-405``) and
``VideoDataCollator`` (``dataset.py:407-554``):

* input_ids pad to a fixed ``max_length`` ceiling (the reference uses 3,072,
  ``dataset.py:408``) and the tile count per video is fixed at
  ``num_segments * tiles_per_frame``.
* The device boundary stays out of the dataset: the reference calls
  ``.to(bfloat16).cuda()`` inside the iterator (``dataset.py:359-360``);
  here items are numpy (``train.trainer.place_batch`` moves a batch to the
  device), and ``prefetch`` keeps a queue of ready batches in a host thread
  so that decoding overlaps the device's work.  Nothing here touches CUDA.
* The gating position is computed at tokenization time and carried as an
  integer field (``prompts.find_gating_position``).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import threading
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .labels import pair_record_labels
from .prompts import GATING_TOKEN_PATTERN, build_video_question, prepare_chat_input
from .video import load_video

_DECIDED = ("Video 1 better", "Video 2 better")


class PreferencePairDataset:
    """Iterates MJ-BENCH-VIDEO pair records -> numpy example dicts."""

    def __init__(
        self,
        json_path: str,
        tokenizer,
        cfg,  # ChatConfig
        root: str = "./datas/videos",
        num_segments: int = 2,
        max_num: int = 1,
        overall: bool = False,
        mse: bool = True,
        gating_pattern: Sequence[int] = GATING_TOKEN_PATTERN,
        decode_workers: int = 0,
    ):
        with open(json_path, encoding="utf-8") as f:
            self.data = json.load(f)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.root = root
        self.num_segments = num_segments
        self.max_num = max_num
        self.overall = overall
        self.mse = mse
        self.gating_pattern = tuple(gating_pattern)
        self.decode_workers = decode_workers

    def __len__(self) -> int:
        # Overall mode counts only decided pairs (``dataset.py:311-320``).
        if not self.overall:
            return len(self.data)
        return sum(1 for item in self.data
                   if item["overall_preference"] in _DECIDED)

    def example(self, item: Dict) -> Optional[Dict[str, np.ndarray]]:
        """One pair record -> example dict, or None (undecided, overall
        mode)."""
        if self.overall and item["overall_preference"] not in _DECIDED:
            return None
        ex = pair_record_labels(item, mse=self.mse)
        caption = item["caption"]
        for v in (0, 1):
            path = os.path.join(self.root, item[f"video_{v}_path"])
            pixels, num_patches_list = load_video(
                path, num_segments=self.num_segments, max_num=self.max_num,
                input_size=self.cfg.image_size)
            question = build_video_question(caption, len(num_patches_list))
            chat = prepare_chat_input(
                self.cfg, self.tokenizer, question,
                num_patches_list=num_patches_list,
                gating_pattern=self.gating_pattern)
            ex[f"video_{v}_pixel_values"] = pixels.astype(np.float32)
            ex[f"video_{v}_input_ids"] = chat.input_ids[0]
            ex[f"video_{v}_attention_mask"] = chat.attention_mask[0]
            ex[f"video_{v}_gating_pos"] = np.asarray(chat.gating_pos, np.int32)
        return ex

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.decode_workers > 0:
            # An ordered pool of decode workers (the reference prefetches
            # with 12 threads, ``dataset.py:299-309``): both videos of a
            # pair decode in one task, pairs concurrently across tasks.
            examples = pool_map(self.example, self.data,
                                num_workers=self.decode_workers)
        else:
            examples = map(self.example, self.data)
        for ex in examples:
            if ex is not None:
                yield ex


class PairCollator:
    """Pad and stack examples into one static-shape batch dict, with the
    fixed-ceiling padding of ``VideoDataCollator.__call__``
    (``dataset.py:414-554``; default 3,072 tokens)."""

    def __init__(self, pad_token_id: int, max_length: int = 3072):
        self.pad_token_id = pad_token_id
        self.max_length = max_length

    def _pad_ids(self, ids: np.ndarray, value: int) -> np.ndarray:
        T = self.max_length
        if ids.shape[0] > T:
            # gating_pos and the last-non-pad pooling index were computed
            # on the whole sequence, so truncating would pool the wrong
            # token.
            raise ValueError(
                f"sequence length {ids.shape[0]} exceeds the collator "
                f"max_length {T}; raise max_length (long-video configs need "
                "~frames*tiles*256 + prompt tokens) instead of truncating")
        return np.pad(ids, (0, T - ids.shape[0]), constant_values=value)

    def __call__(
        self, examples: List[Dict[str, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for key in examples[0]:
            vals = [ex[key] for ex in examples]
            if key.endswith("input_ids"):
                batch[key] = np.stack(
                    [self._pad_ids(v, self.pad_token_id) for v in vals])
            elif key.endswith("attention_mask"):
                batch[key] = np.stack([self._pad_ids(v, 0) for v in vals])
            else:
                if key.endswith("pixel_values") and len(
                        {v.shape for v in vals}) != 1:
                    raise ValueError(
                        "variable tile counts in one batch "
                        f"({sorted({v.shape for v in vals})}); train with "
                        "max_num=1 (the reference's setting, "
                        "dataset.py:357-358) or bucket clips by tile count "
                        "before batching")
                batch[key] = np.stack(vals)
        return batch


def batched(
    dataset: Iterable[Dict[str, np.ndarray]],
    collator: PairCollator,
    batch_size: int,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Group examples into collated batches."""
    buf: List[Dict[str, np.ndarray]] = []
    for ex in dataset:
        buf.append(ex)
        if len(buf) == batch_size:
            yield collator(buf)
            buf = []
    if buf and not drop_remainder:
        yield collator(buf)


def pool_map(
    fn: Callable,
    items: Iterable,
    num_workers: int = 4,
    num_prefetch: Optional[int] = None,
) -> Iterator:
    """Ordered ``map(fn, items)`` with ``num_workers`` threads working ahead
    and at most ``num_prefetch`` (default 2 ``num_workers``) tasks in
    flight.  Video decode releases the GIL (cv2/FFmpeg), so workers overlap
    one another and the device's work.  Results come back in submission
    order; a worker's exception re-raises at its item's position."""
    if num_prefetch is None:
        num_prefetch = 2 * num_workers
    it = iter(items)
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=num_workers)
    pending: deque = deque()

    def fill():
        while len(pending) < num_prefetch:
            try:
                item = next(it)
            except StopIteration:
                return
            pending.append(ex.submit(fn, item))

    try:
        fill()
        while pending:
            result = pending.popleft().result()
            fill()
            yield result
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=False)


def prefetch(it: Iterable, num_prefetch: int = 2) -> Iterator:
    """Run ``it`` in a background host thread, keeping ``num_prefetch`` items
    ready; an exception in it re-raises in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=num_prefetch)
    end = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item
