"""Serving driver for the port: prefill a batch of requests, then decode
greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Counterpart of `repro.launch.serve`, with its flags and its closing log
lines. The decode runs through `core/graphs.py::scan_steps`, as the
reference's runs through its `scan_steps`: on the card one decode step is
captured as a CUDA graph and replayed for every token, with the cache,
the token and the position (a 0-d tensor) updated in place; `--no-scan`
keeps the per-token loop of eager steps. The capture is timed apart
(`capture_s`, its own log line) and `decode_s` excludes it, where the
reference's `decode_s` includes the scan's compile. Runs on the CUDA
device unless `--device cpu` is given, in which case the plain PyTorch
versions stand in for the CUDA kernels and the same step runs eagerly.
Parameters are drawn from the threefry key of `--seed`, as the
reference's `model.init(PRNGKey(seed))` draws them (`Transformer.init`);
the prompts from a generator on the run's device seeded by `--seed`.
Every registered architecture serves (`--arch`), the MoE/MLA ones
(deepseek-v3-671b, arctic-480b) at `--reduced` size: whole, they do not
fit one card. A caller serves them at full width with fewer layers
through `generate` on `Transformer(dataclasses.replace(cfg,
num_layers=n))`, as chip_smoke.py does. The CLI serves token prompts
for every architecture, musicgen-large and llava-next-mistral-7b
included, as the reference's does; `generate(embeds=...)` prefills a
patch prefix or audio frames before them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_architectures
from repro_torch.core.graphs import scan_steps
from repro_torch.core.prng import prng_key
from repro_torch.device import resolve_device
from repro_torch.utils import get_logger
from repro_torch.models import Transformer

log = get_logger("repro_torch.serve")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, prompts, gen: int, window=None,
             scan: bool = True, embeds=None) -> dict:
    """Prefill `embeds` (B, E, d) (a patch prefix or audio frames, or
    None) and then `prompts` (B, S) (or None), and decode `gen` tokens
    greedily from position P = E + S (the prefill's argmax first): with
    `scan`, the gen - 1 decode steps through `scan_steps` (one captured
    step, replayed, on the card), else one eager step a token. Returns
    {"tokens": (B, gen), "logits": (gen, B, V) the logits each token was
    taken from, "prefill_s", "decode_s", "capture_s"}, the times on the
    host clock around work that ends in a device sync; `decode_s`
    excludes `capture_s` (0 without a capture)."""
    P = sum(t.shape[1] for t in (embeds, prompts) if t is not None)
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, embeds=embeds, cache_len=P + gen,
                                  window=window)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tokens = logits.argmax(-1)[:, None]
    out, seen, capture = [tokens], [logits[None]], 0.0
    t0 = time.perf_counter()
    if gen > 1 and scan:
        def step(carry):
            c, t, pos = carry
            lg, c = model.decode_step(c, t, pos, window=window)
            t = lg.argmax(-1)[:, None]
            return (c, t, pos + 1), (t, lg)

        run = scan_steps(step, gen - 1)
        pos = torch.tensor(P, dtype=torch.int32, device=dev)
        _, (rest, lgs) = run((cache, tokens.clone(), pos))
        capture = run.capture_s
        out.append(rest[..., 0].T)  # (gen-1, B, 1) -> (B, gen-1)
        seen.append(lgs)
    elif gen > 1:
        for i in range(gen - 1):
            logits, cache = model.decode_step(cache, tokens, P + i,
                                              window=window)
            tokens = logits.argmax(-1)[:, None]
            out.append(tokens)
            seen.append(logits[None])
    _sync(dev)
    t_decode = time.perf_counter() - t0 - capture
    return {"tokens": torch.cat(out, dim=1), "logits": torch.cat(seen),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "capture_s": capture}


def serve(args, params=None, prompts=None):
    """One serving run. `params` (a training tree, `Transformer.params`)
    and `prompts` ((batch, prompt_len) ints) replace the drawn ones, so
    that a caller can feed in another run's. The parameters are drawn
    from the threefry key of `--seed` (as the training CLI's), the
    prompts from a generator seeded with it. Returns the generated
    tokens (batch, gen) as a numpy array."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg, device)
    if params is None:
        model.init(prng_key(args.seed))
    else:
        model.load_params(params)
    rng = torch.Generator(device=device).manual_seed(args.seed)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (args.batch,
                                                    args.prompt_len),
                                generator=rng, device=device)
    else:
        prompts = torch.as_tensor(prompts, device=device).long()
    window = cfg.sliding_window if args.long_context else None

    res = generate(model, prompts, args.gen, window=window,
                   scan=not args.no_scan)
    B, P = prompts.shape
    if not args.no_scan:
        log.info("capture_s %.3fs (decode step warm-up and CUDA-graph "
                 "capture, outside decode)", res["capture_s"])
    log.info("prefill %.3fs (%d tokens)  decode %.3fs (%.1f tok/s/req)",
             res["prefill_s"], B * P, res["decode_s"],
             (args.gen - 1) / max(res["decode_s"], 1e-9))
    out = res["tokens"].cpu().numpy()
    log.info("generated[0,:16] = %s", out[0, :16].tolist())
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=list_architectures(), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--no-scan", action="store_true",
                    help="per-token decode loop of eager steps, no capture")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
