"""PyTorch port, the street-scale tools path: ``tools/train_street.main``
on the CPU at a tiny size (a 64x48 street scene of 3,000 rows, 2 views,
capacity 4,096).  The first invocation builds the GT through the
self-sized exact path, trains one slice with ``exact_extra=-1`` and
checkpoints; the second resumes from the checkpoint, trains on, appends to
``log.jsonl`` and reports the final PSNR."""

import json

import numpy as np
import torch

from street_sparse_3dgs_tpu_torch.models.serialize import load_checkpoint
from street_sparse_3dgs_tpu_torch.tools import train_street

torch.set_num_threads(1)


def test_train_street_resumes_and_appends(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_street, "W", 64)
    monkeypatch.setattr(train_street, "H", 48)
    monkeypatch.setattr(train_street, "CAPACITY", 4096)
    base = ["--dir", str(tmp_path), "--n", "3000", "--views", "2",
            "--slice", "3", "--wall", "1e9", "--device", "cpu"]
    first = train_street.main(base + ["--iters", "3"])
    assert first["it"] == 3 and len(first["records"]) == 1
    rec = first["records"][0]
    assert rec["exact_extra"] > 0 and rec["exact_extra"] % 128 == 0
    assert rec["tile_of"] == 0 and rec["skipped"] == 0
    z = np.load(tmp_path / "gt.npz")
    assert z["gts"].shape == (2, 3, 48, 64) and z["pts"].shape == (3000, 3)
    state, meta, it = load_checkpoint(tmp_path / "ckpt.npz", device="cpu")
    assert it == 3 and int(state.step) == 3 and meta.capacity == 4096
    assert torch.equal(state.params.xyz, first["state"].params.xyz)

    second = train_street.main(base + ["--iters", "6"])
    out = capsys.readouterr().out
    assert "resumed at iter 3" in out and "FINAL: iters=6" in out
    assert second["it"] == 6 and int(second["state"].step) == 6
    assert len(second["psnrs"]) == 2
    assert all(np.isfinite(second["psnrs"]))
    lines = [json.loads(x) for x in
             (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [x["it"] for x in lines] == [3, 6]
    train_street.main(base + ["--status"])
    assert capsys.readouterr().out.count('"it"') == 2
