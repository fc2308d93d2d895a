"""Hash K4a's and K4b's outputs at fixed inputs, to hold two launches, or
two checkouts' builds of the decoder attention backward, bit for bit on
one card.

    python3 tools/k4_bits.py --root CHECKOUT          # prints one JSON line;
                                                      # exits 1 if a second
                                                      # launch differs
    python3 tools/k4_bits.py --root A --root B        # each in its own
                                                      # process; exits 1 if
                                                      # any hash differs

The inputs are drawn on the card from a seeded generator at training's
(1, 799, 16/8, 128) with every key live and serving's (2, 3072, 16/8, 128)
with a ragged mask and dead rows; lse and delta are computed here in fp32
from an exact causal softmax, so the kernels of both checkouts read the same
bytes.  Each kernel is launched twice and the two outputs compared; the
output is the SHA-256 of each of dk, dv and dq.  Two checkouts agree only
if they sum in the same order: since K4a/K4b moved from the WMMA template
(``attention_bwd.cuh``) onto the wgmma/TMA one (``attention_bwd_sm90.cuh``)
their bits differ from the older checkouts', by the order of the fp32 sums
and where p and dS round to bf16; there the twin
(``decoder_attention_bwd_plain``, ``chip_smoke.py``) is the yardstick, not
this tool.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

SHAPES = ((1, 799, 16, 8, 128, False), (2, 3072, 16, 8, 128, True))


def _inputs(shape, gen, dev):
    import torch

    B, T, Hq, Hkv, D, ragged = shape
    q, k, v, dout = (torch.randn(s, generator=gen, device=dev)
                     .to(torch.bfloat16) for s in
                     ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D),
                      (B, T, Hq, D)))
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if ragged:
        mask[1, T - 600:] = 0
        mask[1, :5] = 0
    G = Hq // Hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 2)) * D ** -0.5
    allowed = (torch.ones(T, T, device=dev).tril().bool()[None, None]
               & (mask != 0)[:, None, None, :])
    s = s.masked_fill(~allowed, -1e30)
    lse = torch.logsumexp(s, -1)
    dead = ~allowed.any(-1)
    lse = lse.masked_fill(dead, 1e30).contiguous()
    p = torch.exp(s - lse[..., None]).masked_fill(~allowed, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p,
                       v.float().repeat_interleave(G, 2))
    delta = (dout.float() * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, lse, delta, mask


def run(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from mjvideo_tpu_torch import kernels

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    hashes, again = {}, True
    for shape in SHAPES:
        q, k, v, dout, lse, delta, mask = _inputs(shape, gen, dev)
        scale = shape[4] ** -0.5
        runs = [(*kernels.decoder_attention_bwd_dkdv(q, k, v, dout, lse,
                                                     delta, mask, None, scale),
                 kernels.decoder_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                  mask, None, scale))
                for _ in range(2)]
        torch.cuda.synchronize()
        again &= all(torch.equal(a, b) for a, b in zip(*runs))
        for name, t in zip(("dk", "dv", "dq"), runs[0]):
            raw = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            hashes[f"{shape[:5]} {name}"] = hashlib.sha256(raw).hexdigest()
    return {"root": root, "lib": str(kernels.build()), "sha256": hashes,
            "second_launch_bit_identical": bool(again)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    args = ap.parse_args()
    if len(args.root) == 1:
        res = run(args.root[0])
        print(json.dumps(res))
        return 0 if res["second_launch_bit_identical"] else 1
    runs = []
    for root in args.root:
        res = subprocess.run([sys.executable, __file__, "--root", root],
                             capture_output=True, text=True)
        if res.returncode not in (0, 1):
            raise RuntimeError(f"{root}: exit {res.returncode}\n"
                               f"{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    same = all(r["sha256"] == runs[0]["sha256"] for r in runs)
    again = all(r["second_launch_bit_identical"] for r in runs)
    print(f"K4a and K4b outputs bit-identical across {args.root}: {same}; "
          f"a second launch bit-identical in each: {again}")
    same = same and again
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
