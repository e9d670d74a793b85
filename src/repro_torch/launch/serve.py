"""Batched serving: prefill a batch of prompts, then decode one token
at a time against the KV cache (greedy or temperature sampling).

Counterpart of ``repro.launch.serve``; runs on the CUDA device unless
``device=`` says otherwise.  Weights are drawn from a ``torch.Generator``
seeded with ``seed``, sampling from another seeded with ``seed + 1``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b --smoke \
        --batch 8 --prompt-len 64 --gen 32
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as model
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.train.step import make_serve_step

__all__ = ["serve_batch", "main"]


def serve_batch(arch: str, *, smoke: bool = True, batch: int = 8,
                prompt_len: int = 64, gen: int = 32, temperature: float = 0.0,
                seed: int = 0, device: str | torch.device | None = None):
    """Returns (the generated tokens (B, gen) as a numpy int32 array, stats:
    ``prefill_s``, ``prefill_tok_s``, ``decode_s``, ``decode_tok_s``)."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not cfg.supports_decode():
        raise ValueError(f"{arch} is encoder-only; no decode path")
    weights = torch.Generator(device=device)
    weights.manual_seed(seed)
    params = model.init_params(weights, cfg, device=device)
    max_len = prompt_len + gen

    prompts = make_batch(cfg, batch, prompt_len, seed=seed, step=0,
                         device=device)
    prompts.pop("targets", None)
    serve_step = make_serve_step(cfg)

    def wait() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sampler = torch.Generator(device=device)
    sampler.manual_seed(seed + 1)
    with torch.inference_mode():
        cache = model.init_cache(cfg, batch, max_len, device=device)
        wait()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, cfg, cache)
        wait()
        t_prefill = time.perf_counter() - t0

        toks = []
        t0 = time.perf_counter()
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(gen):
            toks.append(tok)
            logits, cache = serve_step(params, cache, tok, prompt_len + i)
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, -1)
                tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
                tok = tok.to(torch.int32)
            else:
                tok = torch.argmax(logits, -1).to(torch.int32)
        wait()
        t_decode = time.perf_counter() - t0

    out = torch.stack(toks, dim=1).cpu().numpy()  # (B, gen)
    stats = {
        "prefill_s": t_prefill,
        "prefill_tok_s": batch * prompt_len / t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": batch * gen / max(t_decode, 1e-9),
    }
    return out, stats


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args()
    out, stats = serve_batch(args.arch, smoke=args.smoke, batch=args.batch,
                             prompt_len=args.prompt_len, gen=args.gen,
                             temperature=args.temperature, device=args.device)
    print(f"[serve] generated shape={out.shape}")
    for k, v in stats.items():
        print(f"[serve] {k}={v:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
