"""LM serving with the port: batched prefill + greedy decode, on the GPU
by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 4 --prompt-len 2048 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Every architecture of ``configs.ARCH_IDS`` serves (``--arch``): dense GQA,
MoE (dbrx, deepseek-v2 with MLA), the ViT stub (pixtral), SSM (mamba2),
RG-LRU with windowed attention (recurrentgemma) and the encoder-decoder
(seamless).  Random weights from ``--seed`` (nothing is downloaded),
random prompt tokens, and, as the reference's CLI, random stub inputs:
``patch_embeds`` (bf16) for the ViT stub, ``frames`` for the
encoder-decoder, ``frontend_tokens`` of them per request.  A prefill
attention without a window (causal, or the encoder's bidirectional one)
runs on the flash-attention kernel
(``kernels/csrc/flash_attention.cu``), one launch per such layer; decode
steps attend to the caches through the plain blocked attention.  The
whole dbrx-132b and deepseek-v2-236b (263 GB and 471 GB in bf16) do not
fit one 80 GB card.
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
    batch = stub_batch(cfg, np.random.default_rng(args.seed), args.batch,
                       args.prompt_len, dev)
    smax = serve_smax(cfg, args.prompt_len, args.gen)
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


def stub_batch(cfg, rng, B: int, S: int, dev):
    """Random prompt tokens [B, S] and, as the reference's CLI, the stub
    inputs, drawn in that order from the numpy generator `rng`:
    ``patch_embeds`` (bf16) for the ViT stub, ``frames`` (f32) for the
    encoder-decoder, ``frontend_tokens`` of them per request."""
    import numpy as np
    import torch

    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S))).to(dev)}
    stub = (B, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "vit_stub":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            stub, dtype=np.float32)).to(dev, torch.bfloat16)
    if cfg.encdec is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            stub, dtype=np.float32)).to(dev)
    return batch


def serve_smax(cfg, S: int, gen: int) -> int:
    """Decode cache slots for an S-token prompt and `gen` generated
    tokens: the ViT stub's ``frontend_tokens`` patches stand in front of
    the text in the cache too (the reference's CLI leaves them out, and
    its cache write then lands past the end)."""
    prefix = cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0
    return prefix + S + gen + 8


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
