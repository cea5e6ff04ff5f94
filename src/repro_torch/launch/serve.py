"""Batched LM serving driver, slot-based continuous batching; port of
``repro.launch.serve``.

This is the LANGUAGE-MODEL scaffolding demo: it serves transformer text
generation, not convolutional-code decoding (that is ``repro_torch.serve``
and examples/torch_serve_viterbi.py).

Requests arrive with different prompt lengths. Each admitted prompt is
prefilled token by token through the batched decode step into its slot,
then all live requests decode in ONE batched step per token; finished
requests retire and queued ones take the freed slots. As in the JAX
package, the attention caches keep one write index for the whole batch,
so a slot's prefill advances every slot, and the greedy argmax runs over
the padded vocabulary.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_32b \\
      --requests 6 --slots 4 --gen 16 [--device cpu]

``--reduced`` is accepted and always on, as in the JAX package: the demo
serves the architecture's reduced config with random weights from seed 0.
``serve_requests`` is the slot loop for any config and weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config
from ..models import build_model

__all__ = ["serve_requests", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_requests(bundle, params, prompts, slots: int, gen: int,
                   max_seq: int):
    """Serve ``prompts`` (lists of token ids) greedily, ``gen`` tokens
    each, over ``slots`` batch slots. Returns ``(done, stats)``: ``done``
    maps request id -> generated tokens; ``stats`` holds the batched
    decode ``steps``, the wall ``seconds`` and each batched step's
    ``step_ms`` (host clock around the step and its argmax read-back)."""
    dev = bundle.device
    queue = list(enumerate(prompts))
    B = slots
    cache = bundle.init_cache(params, B, max_seq)
    live = [None] * B                  # per-slot: (req_id, generated, left)
    cur = np.zeros((B, 1), np.int64)
    done, step_ms = {}, []

    def decode(tokens, cache):
        return bundle.decode(params, torch.as_tensor(tokens, device=dev),
                             cache)

    def admit(slot, cache):
        req_id, prompt = queue.pop(0)
        # prefill the prompt token by token into this slot's cache lane
        # (the other slots feed their current tokens alongside)
        for t in prompt[:-1]:
            tok = cur.copy()
            tok[slot, 0] = t
            _, cache = decode(tok, cache)
        cur[slot, 0] = prompt[-1]
        live[slot] = (req_id, [], gen)
        return cache

    _sync(dev)
    t0 = time.perf_counter()
    while queue or any(live):
        for s in range(B):
            if live[s] is None and queue:
                cache = admit(s, cache)
        _sync(dev)
        ts = time.perf_counter()
        logits, cache = decode(cur, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        for s in range(B):
            if live[s] is None:
                continue
            rid, toks, left = live[s]
            toks.append(int(nxt[s]))
            cur[s, 0] = int(nxt[s])
            if left - 1 == 0:
                done[rid] = toks
                live[s] = None
            else:
                live[s] = (rid, toks, left - 1)
    _sync(dev)
    return done, {"steps": len(step_ms),
                  "seconds": time.perf_counter() - t0, "step_ms": step_ms}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    if cfg.family == "encdec":
        raise SystemExit("serve demo targets decoder-only archs")
    bundle = build_model(cfg, device=args.device)
    params = bundle.init(torch.Generator(bundle.device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
               for _ in range(args.requests)]
    done, stats = serve_requests(bundle, params, prompts, args.slots,
                                 args.gen, args.max_seq)
    for rid in sorted(done):
        print(f"req {rid}: {done[rid][:8]}... ({len(done[rid])} tokens)")
    total = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests, {total} tokens, "
          f"{total / stats['seconds']:.1f} tok/s, {stats['steps']} batched "
          f"decode steps on {bundle.device}")
    return done


if __name__ == "__main__":
    main()
