"""LM serving with the port: batched prefill + greedy decode, on the GPU
by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 4 --prompt-len 2048 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Random weights from ``--seed`` (nothing is downloaded) and random prompt
tokens.  The prefill's attention runs on the flash-attention kernel
(``kernels/csrc/flash_attention.cu``), one launch per layer; decode
steps attend to the KV cache through the plain blocked attention.
``--device cpu`` runs the plain PyTorch path on the CPU (the kernel's
wrapper takes its plain version there); without a GPU and without it the
command fails instead of moving to the CPU.  Prints the card's name, the
prefill's ms, the decode's ms per token, tokens per second and the
kernel's launches.  ``--profile`` then traces one more prefill and its
decode steps apart with ``torch.profiler`` and prints, for each, the
device time by kernel and the device's busy share of its wall time.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.serve_step import generate

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace a prefill and its decode steps apart")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    params = init_params(MD.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(args.seed),
                         dev)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    smax = args.prompt_len + args.gen + 8
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    stats = {}
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = generate(params, cfg, batch, steps=args.gen, smax=smax,
                   temperature=args.temperature, seed=args.seed,
                   stats=stats)
    wall = time.perf_counter() - t0
    decode_ms = (stats["decode_s"] / max(args.gen - 1, 1)) * 1e3
    print(f"arch={cfg.name} device={name} generated {tuple(out.shape)} in "
          f"{wall:.3f} s ({args.batch * args.gen / wall:.1f} tok/s): "
          f"prefill {stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{decode_ms:.3f} ms/token, flash_attention launches "
          f"{flash_attention.launches}")
    print("sample:", out[0].tolist())
    if args.profile:
        _profile(params, cfg, batch, smax, args.gen, dev)


def _profile(params, cfg, batch, smax, gen, dev):
    """Device time by kernel and busy share of a prefill and of its
    `gen - 1` greedy decode steps, each traced apart."""
    import torch

    from repro_torch.launch.solve import _profile_report, _profiler
    from repro_torch.train.serve_step import decode_step, prefill_step

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    with _profiler(dev.type) as prof:
        t0 = time.perf_counter()
        tok, caches = prefill_step(params, cfg, batch, smax)
        sync()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, "prefill")
    with _profiler(dev.type) as prof:
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok, caches, _ = decode_step(params, cfg, tok[:, None], caches)
        sync()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, f"decode ({gen - 1} steps)")


if __name__ == "__main__":
    main()
