"""Where the time of the InternVL2-2B judge goes on a CUDA card: prefill
against decode.

    python3 tools/profile_torch_judge.py [--quant MODE] [--out FILE]

Builds ``chip_smoke.py``'s judge (random bf16 weights from its seed, the
pair's seeded 8-frame videos; quantized on the card in the serving mode
``--quant``, e.g. ``"int4-wo"``, if one is given) and the full-prompt path's inputs (the
overall prompt, B = 2 left-padded in the 3,072 bucket).  Times the prefill
and a decode loop of STEPS steps without the profiler, then traces each with
device activity only and prints wall time, device kernel time, the busy
share against the unprofiled wall, and device time by kernel group and by
kernel (``--out`` keeps the decode's full table).  Last, it traces the
decode loop's host side and prints the ops that take the most host time.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
STEPS = 16


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_judge: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import JUDGE_CAPTION, SEED, _full_inputs, make_judge
    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.models import generate as gen
    from tools.profile_torch_scoring import report

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; serving mode {args.quant or 'bf16'}")
    judge = make_judge(generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, quant=args.quant)
    ids, mask, gc, vis = _full_inputs(judge, overall_prompt(JUDGE_CAPTION),
                                      ("video_0", "video_1"))
    gc = gc._replace(max_new_tokens=STEPS + 1, eos_token_id=-1)
    lm, cfg = judge.params["language_model"], judge.cfg

    def prefill():
        embeds = gen._embed(judge.params, cfg, ids, None, vis, "auto")
        return gen._prefill(judge.params, cfg, embeds, ids, mask,
                            gc.max_new_tokens, "auto", False)

    def decode(state):
        logits, cache, cmask, start = state
        return gen._decode_from_logits(lm, cfg.llm, gc, logits, cache, cmask,
                                       start, None, "auto")

    def wall(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    with torch.no_grad():
        for _ in range(2):
            decode(prefill())
        prefill_s = wall(prefill, 3)
        state = prefill()
        decode_s = wall(lambda: decode(state), 2) / STEPS
        for part, fn, n, out in (
                ("prefill", prefill, 1, None),
                ("decode", lambda: decode(state), STEPS, args.out)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                traced = time.perf_counter() - t0
            unit = "prefill" if part == "prefill" else "step"
            report(prof, traced, n, f"{part} of the pair's full prompt "
                   f"{tuple(ids.shape)}", unit, smi, out,
                   unprofiled=prefill_s if part == "prefill" else decode_s)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            decode(state)
    print(f"host side of {STEPS} decode steps, ops by self host time:")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=14))
    return 0


if __name__ == "__main__":
    sys.exit(main())
