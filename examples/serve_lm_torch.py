"""End-to-end LM serving on the PyTorch/CUDA port: batched prefill +
decode loop with a KV cache (a recurrent state for xLSTM and Mamba2), for
any decoder arch in the registry: dense, moe (dbrx_132b,
deepseek_v2_lite_16b), vlm, ssm (xlstm_125m) and hybrid (zamba2_7b).  The
prompt length must divide by the recurrent archs' chunk, min(chunk, prompt).

Run on the GPU:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen2_5_3b] [--full]
or on the host:  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse

from repro_torch.launch.serve import serve_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args()

    out, stats = serve_batch(args.arch, smoke=not args.full,
                             batch=args.batch, prompt_len=args.prompt_len,
                             gen=args.gen, device=args.device)
    print(f"[serve_lm] batch={args.batch} generated {out.shape[1]} tokens/seq")
    for k, v in stats.items():
        print(f"[serve_lm] {k}={v:.2f}")


if __name__ == "__main__":
    main()
