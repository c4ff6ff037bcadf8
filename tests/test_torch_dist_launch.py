"""The quantize launcher under `torch.distributed.run` (gloo, the CPU):
`--shard-data --shard-solve 2` on 4 ranks prints JAX's summary keys once
and writes one .qpk; a journaled 2-rank run followed by a 2-rank
`--resume` re-applies every leaf and writes the same bytes, and so does a
2-rank run killed after a layer and restarted; a world that is not the
mesh's size exits 2."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the JAX launcher's summary keys (repro/launch/quantize.py)
JAX_KEYS = {"arch", "method", "bits", "mixed_policy", "bits_budget",
            "propagation", "data_shards", "model_shards", "order",
            "granularity", "layers_quantized",
            "comq_vs_rtn_error_improvement", "fp_loss", "quant_loss",
            "seconds", "ckpt_bytes", "dense_bytes", "compression",
            "guard_events", "resumed_leaves", "faults_fired"}
SMOKE = ["--arch", "qwen2-7b", "--smoke", "--method", "comq_blocked",
         "--calib-batch", "4", "--calib-seq", "48", "--device", "cpu"]


def torchrun(n, args, cwd, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "repro_torch.launch.quantize",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)
    summaries = [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
    return proc, summaries


def test_four_ranks_shard_data_and_solve(tmp_path):
    proc, out = torchrun(4, SMOKE + ["--shard-data", "--shard-solve", "2",
                                     "--save-packed", "q.qpk", "--out-dir",
                                     "ckpt"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(out) == 1, proc.stdout            # rank 0 alone prints
    s = out[0]
    assert set(s) == JAX_KEYS
    assert (s["data_shards"], s["model_shards"]) == (2, 2)
    assert s["layers_quantized"] == 14 and s["guard_events"] == 0
    assert s["comq_vs_rtn_error_improvement"] > 0.2
    assert abs(s["quant_loss"] - s["fp_loss"]) <= 0.15
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt", "q.qpk"]
    from repro_torch.ckpt import load_packed_ckpt
    assert load_packed_ckpt(str(tmp_path / "q.qpk"))["arch"] == s["arch"]


def test_journaled_two_ranks_resume_reapplies_every_leaf(tmp_path):
    args = SMOKE + ["--shard-data", "--shard-solve", "2", "--journal",
                    "journal"]
    proc, out = torchrun(2, args + ["--save-packed", "a.qpk"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (out[0]["data_shards"], out[0]["model_shards"]) == (1, 2)
    assert out[0]["resumed_leaves"] == 0
    proc, out = torchrun(2, args + ["--resume", "--save-packed", "b.qpk"],
                         tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(out) == 1 and out[0]["resumed_leaves"] == 14
    assert (tmp_path / "a.qpk").read_bytes() == \
        (tmp_path / "b.qpk").read_bytes()
    from repro_torch.ft import QuantJournal
    st = QuantJournal.replay(str(tmp_path / "journal"))
    assert len(st.leaves) == 14
    # killed after layer 0 on both ranks, restarted and resumed in turn
    proc, out = torchrun(2, SMOKE + ["--shard-data", "--shard-solve", "2",
                                     "--journal", "killed", "--inject",
                                     "kill:1", "--restarts", "2",
                                     "--save-packed", "c.qpk"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(out) == 1 and out[0]["faults_fired"] == 1
    assert out[0]["resumed_leaves"] == 7
    assert (tmp_path / "c.qpk").read_bytes() == \
        (tmp_path / "a.qpk").read_bytes()


@pytest.mark.parametrize("argv", [["--shard-solve", "2"],
                                  ["--shard-solve", "3", "--shard-data"]])
def test_world_that_is_not_the_mesh_exits_2(argv, capsys):
    """A world of one (no torchrun) cannot hold a model axis of 2 or 3."""
    from repro_torch.launch import quantize
    with pytest.raises(SystemExit) as e:
        quantize.main(SMOKE + argv)
    assert e.value.code == 2
    assert "world of 1 ranks" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
