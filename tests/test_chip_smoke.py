"""chip_smoke.py: the GPU-only driver refuses the CPU, and its phases
run end to end at a tiny shape on the conftest's virtual CPU devices."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from matfac_tpu.models.base import ModelMF, init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_users=300, n_items=200, n_ratings=9000)
K = 8


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_contract_line_keys():
    import jax
    line = json.loads(chip_smoke.contract_line(jax.devices()[:1]))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == 1


@pytest.fixture(scope="module")
def tiny():
    return chip_smoke.make_star_data(**TINY, seed=3)


def _init_view(data):
    p = chip_smoke._params(K, 0)
    model = ModelMF(p, data.n_users, data.n_items)
    return model.eval_view(init_state(p, data.n_users, data.n_items))


@pytest.mark.parametrize("phase", ["train", "rank_serve", "reference",
                                   "determinism", "cli", "four_cards"])
def test_phase_runs_at_tiny_shape(tiny, phase):
    if phase == "train":
        res = chip_smoke.phase_train(tiny, K, 0)
        assert res["mf"]["engine"] == "als"
        assert res["tmf"]["engine"] == "densesgd"
        assert res["tmf"]["val_rmse"][-1] < res["tmf"]["val_rmse"][0]
    elif phase == "rank_serve":
        res = chip_smoke.phase_rank_serve(tiny, _init_view(tiny), K, 0,
                                          n_serve=32)
        assert res["bpr"]["engine"] == "bpr_dense"
        assert 0.0 <= res["hr10"]["value"] <= 1.0
    elif phase == "reference":
        res = chip_smoke.phase_reference(tiny, K, 0)
        for prec in ("default", "highest"):
            assert res[prec]["top10"]["serve_mismatches"] == 0
            assert res[prec]["als_solve"]["max_rel"] <= 1e-4
    elif phase == "determinism":
        res = chip_smoke.phase_determinism(tiny, K, 0)
        assert isinstance(res["bitwise_equal"], bool)
    elif phase == "cli":
        res = chip_smoke.phase_cli(tiny, K, 0, timeout=600)
        assert set(res["rmse"]) == {"train", "test", "val"}
    else:
        res = chip_smoke.phase_four_cards(tiny, K, 0, n_devices=4)
        assert res["hr10"]["sharded"] == res["hr10"]["unsharded"]
        assert res["hr10"]["top10_ids_equal_frac"] == 1.0
        assert all(len(ids) == 4 for ids in res["device_sets"].values())
    assert not res.get("_failures"), res["_failures"]


def test_star_data_hits_rating_count(tiny):
    n = tiny.train_mat.nnz + tiny.test_mat.nnz + tiny.val_mat.nnz
    assert abs(n - TINY["n_ratings"]) < 0.03 * TINY["n_ratings"]
    vals = tiny.train_mat.values
    assert vals.min() >= 0.5 and vals.max() <= 5.0
    assert set((vals * 2).astype(int).tolist()) <= set(range(1, 11))
