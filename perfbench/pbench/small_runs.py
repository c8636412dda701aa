"""Runs of the harness on the CPU at a small size of a cell's
configuration, held to the cell's own limits: what the tests of
`correct` drive (`test_perfbench_correct_*.py`)."""
import json
import time
from pathlib import Path

import torch

from pbench import harness

MAN = harness.manifest()
SMALL = {
    "fedgia_lsq": {"data": {"clients": 64, "features": 32, "samples": 1024,
                            "rows": 24}},
    "fedgia_lm": {"model": {
        "name": "small", "hidden_size": 64, "intermediate_size": 96,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 4, "vocab_size": 256, "rope_theta": 1e6,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
        "torch_dtype": "bfloat16"}},
}
SMALL_TRAFFIC = {"fedgia_lm": {"seqs_per_client": 2, "seq_len": 16}}


def cells(system: str):
    """The manifest's cells whose configuration runs `system`."""
    return [w["name"] for w in MAN["workloads"]
            if harness.cell_files(w["name"], MAN)[1]["system"] == system]


def small_root(tmp_path: Path, cell: str) -> Path:
    """A checkout holding `cell` alone, its configuration cut small, its
    workload (limits included) as the benchmark states it."""
    entry, cfg, wl = harness.cell_files(cell, MAN)
    cfg = {**cfg, **SMALL[cfg["system"]]}
    wl = {**wl, **SMALL_TRAFFIC.get(cfg["system"], {}),
          "chunk": 2, "trace_chunks": 1}
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    (tmp_path / "perfbench" / "workloads").mkdir()
    conf = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    (tmp_path / conf["file"]).write_text(json.dumps(cfg))
    (tmp_path / "perfbench" / "workloads" / f"{cell}.json").write_text(
        json.dumps(wl))
    man = {**MAN, "configs": [conf], "workloads": [entry]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp_path


def run(root, cell, **kw):
    """One run of `cell` on the CPU from `root`, on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(cell, 2 ** 31 + 7, 0.05, False,
                                torch.device("cpu"), time.time(),
                                lambda msg: None, root=root, **kw)
    finally:
        torch.set_num_threads(threads)


def break_round(monkeypatch, kind: str):
    """Break `FedGiA.round_flat` underneath the driver: "unchanged" (the
    round returns the state it was given) or "half_batch" (each client's
    loss over half of its batch, the mean over the rest)."""
    from repro_torch.core.fedgia import FedGiA
    real = FedGiA.round_flat

    def unchanged(self, state, batch, spec, **kw):
        copy = {k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in state.items()}
        _, met = real(self, copy, batch, spec, **kw)
        return dict(state, round=state["round"] + 1), met

    def half_batch(self, state, batch, spec, **kw):
        if "tokens" in batch:
            tok = batch["tokens"]
            half = {"tokens": tok[:, :tok.shape[1] // 2]}
        else:
            rows = batch["mask"].shape[1]
            keep = torch.ceil(batch["mask"].sum(1, keepdim=True) / 2)
            half = {**batch, "mask": batch["mask"] * (torch.arange(rows)
                                                      < keep)}
        return real(self, state, half, spec, **kw)

    monkeypatch.setattr(FedGiA, "round_flat",
                        {"unchanged": unchanged,
                         "half_batch": half_batch}[kind])
