#!/usr/bin/env python3
"""Serve one LM from several checkouts of the repository in turn on one
GPU, to compare two versions of the serving path on the same card:

    python3 scripts/serve_ab.py checkout/parent . . checkout/parent

Each root runs in a process of its own, which imports that root's
``src/repro_torch``: random weights from seed 0, `--batch` requests of
`--prompt-len` tokens, `--gen` generated, through `generate` three times
(cold, then warm twice).  Each run prints its prefill ms, decode ms per
token and flash_attention launches; the card's name and power limit come
first.  Host-bound numbers (decode) vary from run to run, so give each
root more than once, in turns.
"""

import argparse
import os
import subprocess
import sys
import time


def serve(root, arch, batch, prompt_len, gen):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.serve_step import generate
    print(f"{root}: {os.path.dirname(repro_torch.__file__)}")
    cfg = configs.get(arch)
    params = init_params(MD.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, prompt_len))).cuda()
    for run in ("cold", "warm", "warm"):
        stats = {}
        flash_attention.launches = 0
        t0 = time.perf_counter()
        generate(params, cfg, {"tokens": tokens}, steps=gen,
                 smax=prompt_len + gen + 8, stats=stats)
        torch.cuda.synchronize()
        print(f"{root} {run}: prefill {stats['prefill_s'] * 1e3:.3f} ms, "
              f"decode {stats['decode_s'] / max(gen - 1, 1) * 1e3:.3f} "
              f"ms/token, flash_attention launches {flash_attention.launches}"
              f", wall {time.perf_counter() - t0:.3f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="repository checkouts, in turn")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--one", action="store_true",
                    help="serve from the single root given, in this process")
    args = ap.parse_args()
    if args.one:
        serve(args.roots[0], args.arch, args.batch, args.prompt_len,
              args.gen)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in args.roots:
        rc = subprocess.call(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--arch", args.arch, "--batch", str(args.batch),
             "--prompt-len", str(args.prompt_len), "--gen", str(args.gen)])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
