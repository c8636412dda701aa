"""Batched serving example: mixed-length requests, prefill and a captured
decode loop, greedy sampling, per-phase token accounting (counterpart of
`examples/serve_requests.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_requests \
        --arch tinyllama-1.1b [--device cpu] [--no-scan]

The reduced config, as the reference's. The prompts are the reference's:
lengths and tokens drawn from `np.random.default_rng(0)` in its order,
left-padded with token 0 into one batch. The decode goes through
`launch/serve.py::generate`: on the card one step is captured as a CUDA
graph and replayed for every token (`--no-scan`: eager steps). Prints
the reference's lines, and the capture's time on a line of its own.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, list_architectures
from repro_torch.core.prng import prng_key
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import Transformer


def make_prompts(requests: int, max_prompt: int, vocab_size: int):
    """(lens, prompts): the reference's draw, (requests, max_prompt)
    int32 with each request's tokens at the right end."""
    rng = np.random.default_rng(0)
    lens = rng.integers(max_prompt // 2, max_prompt + 1, requests)
    prompts = np.zeros((requests, max_prompt), np.int32)
    for i, L in enumerate(lens):
        prompts[i, -L:] = rng.integers(1, vocab_size, L)
    return lens, prompts


def run(args, params=None) -> np.ndarray:
    """Serve the requests; `params` (a training tree, `Transformer.params`)
    replaces the drawn parameters. Returns the generated tokens
    (requests, gen)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Transformer(cfg, device)
    if params is None:
        model.init(prng_key(0))
    else:
        model.load_params(params)
    lens, prompts = make_prompts(args.requests, args.max_prompt,
                                 cfg.vocab_size)
    print(f"arch={cfg.name} requests={args.requests} "
          f"prompt lens={lens.tolist()}")

    res = generate(model, torch.as_tensor(prompts, device=device).long(),
                   args.gen, scan=not args.no_scan)
    out = res["tokens"].cpu().numpy()
    tok_s = args.requests * (args.gen - 1) / max(res["decode_s"], 1e-9)
    print(f"prefill: {args.requests * args.max_prompt} tokens in "
          f"{res['prefill_s']:.3f}s")
    if not args.no_scan:
        print(f"capture: {res['capture_s']:.3f}s (outside decode)")
    print(f"decode : {args.gen - 1} steps in {res['decode_s']:.3f}s "
          f"({tok_s:.1f} tok/s aggregate)")
    for i in range(args.requests):
        print(f"  req{i} -> {out[i].tolist()}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_requests")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list_architectures())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--no-scan", action="store_true",
                    help="per-token decode loop of eager steps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
