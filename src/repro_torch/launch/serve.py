"""Batched serving: prefill + decode loop with KV cache (twin of
``repro.launch.serve``), on the CUDA card unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

As in the reference, the model is always the reduced config (``--reduced``
is on by default and cannot be turned off) with random weights from seed 0;
the prompt is fed token by token through the decode step, then the greedy
tokens.  ``main(argv)`` returns the generated tokens, (batch, tokens).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import all_configs
from repro_torch.models.registry import build_model
from repro_torch.train.train_step import make_serve_step


def greedy_decode(model, params, prompt: np.ndarray, tokens: int,
                  max_len: int, meta: int, device) -> np.ndarray:
    """Feed ``prompt`` (B, P) one token at a time through the serve step,
    then the greedy tokens; returns the ``tokens`` generated, (B, tokens).  The
    tokens stay on the card until the end (one copy back)."""
    B, n_prompt = prompt.shape
    cache = model.init_cache(B, max_len, device=device)
    serve_step = make_serve_step(model)
    prompt_t = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    tok = prompt_t[:, :1]
    out_tokens = []
    for i in range(n_prompt + tokens - 1):
        nxt, cache = serve_step(params, cache, tok, meta + i + 1)
        if i + 1 < n_prompt:
            tok = prompt_t[:, i + 1:i + 2]
        else:
            tok = nxt[:, None]
            out_tokens.append(nxt)
    return torch.stack(out_tokens, 1).cpu().numpy()


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = all_configs()[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(0, device)

    B = args.batch
    meta = getattr(cfg, "num_meta_tokens", 0)
    max_len = meta + args.prompt_len + args.tokens + 8
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, (B, args.prompt_len))
    t0 = time.time()
    gen = greedy_decode(model, params, prompt, args.tokens, max_len, meta,
                        device)
    dt = time.time() - t0
    print(f"[serve] generated {gen.shape} in {dt:.2f}s "
          f"({B * gen.shape[1] / dt:.1f} tok/s)")
    print("[serve] sample:", gen[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
