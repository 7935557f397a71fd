"""Batched serving example: prefill + greedy decode with a KV cache (twin of
``examples/serve_lm.py``), on the CUDA card unless ``--device`` says
otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma3-1b --tokens 24
      (``--device cpu`` for the plain path)
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import all_configs
from repro_torch.launch.serve import greedy_decode
from repro_torch.models.registry import build_model


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = all_configs()[args.arch].reduced()
    model = build_model(cfg)
    params = model.init(0, device)
    B = args.batch
    meta = getattr(cfg, "num_meta_tokens", 0)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, (B, args.prompt_len))
    t0 = time.time()
    gen = greedy_decode(model, params, prompt, args.tokens,
                        meta + args.prompt_len + args.tokens + 4, meta,
                        device)
    dt = time.time() - t0
    print(f"[serve] {args.arch}: generated {gen.shape[1]} tokens × "
          f"batch {B} in {dt:.1f}s ({B * gen.shape[1] / dt:.1f} tok/s)")
    print("[serve] first sequence:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
