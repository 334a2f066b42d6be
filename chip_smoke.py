"""Smoke run of the main path on one GPU.

    python chip_smoke.py               # one card, the default run
    python chip_smoke.py --four-cards  # only the 4-card mesh phase

Drives training, ranking and serving through the entry points a user
calls (``train_model``, ``CatalogScorer``, ``Recommender``, the CLI) at
the MovieLens-20M shape (138,493 users x 26,744 items, ~20.0M ratings
in 0.5-step stars, power-law item degrees, k = 64), compares each
kernel on that path with a plain numpy float64 reference at the
default matmul precision and at "highest", and records whether two
scatter-SGD epochs agree bitwise. Data is synthesised from ``--seed``.

Every phase prints one JSON line (name, wall seconds, the engine that
ran, its comparison numbers). The card's name and power limit come
first, as nvidia-smi reports them. The last line is the contract line
``{"ok": true, "device": {...}}``, printed only when every phase
passed. With no GPU the script exits non-zero and prints no such line:
there is no CPU path through it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# MovieLens-20M: 138,493 users, 26,744 items, 20,000,263 ratings in
# 0.5..5.0 stars (the GroupLens README); k = 64 is the flagship rank
ML20M = dict(n_users=138_493, n_items=26_744, n_ratings=20_000_263)
# the medium shape of the repo's benchmark: 20k x 5k at 5% density
MEDIUM = dict(n_users=20_000, n_items=5_000, n_ratings=5_000_000)
K = 64
POWER_LAW = 0.8

# ALS: f32 Cholesky on the first epoch's Grams against float64
ALS_HIGHEST_RTOL = 1e-4
# dense stripe: relative error of the update (U' - U, I' - I). bf16
# operands carry 2^-9 relative rounding each; f32 at "highest" only
# accumulation-order error
STRIPE_RTOL = {"bf16": 3e-2, "f32_highest": 1e-4}
# 3-epoch val RMSE at the default precision against "highest"
RMSE_REL_TOL = 0.01


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

def _draws_for_unique(target: int, n_users: int, n_items: int,
                      power_law: float) -> int:
    """Zipf draws whose expected count of distinct (user, item) pairs
    is ``target`` (low_rank_ratings dedupes repeated pairs)."""
    p = 1.0 / np.arange(1, n_items + 1) ** power_law
    p /= p.sum()

    def expected(n):
        return float(np.sum(n_users * -np.expm1(-n * p / n_users)))

    lo, hi = float(target), 4.0 * target
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if expected(mid) < target else (lo, mid)
    return int(hi)


def make_star_data(n_users: int, n_items: int, n_ratings: int,
                   seed: int, power_law: float = POWER_LAW):
    """Rank-8 nonnegative ratings quantised to 0.5-step stars and split
    10% test / 5% val — the recipe of scripts/ml20m_flagship.py at the
    requested shape and (expected) rating count."""
    from matfac_tpu.data.dataset import Data
    from matfac_tpu.data.io import split_train_test_val
    from matfac_tpu.data.synthetic import low_rank_ratings

    draws = _draws_for_unique(n_ratings, n_users, n_items, power_law)
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8,
                                 density=draws / (n_users * n_items),
                                 seed=seed, noise=0.35,
                                 power_law=power_law, nonneg=True)
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    tr, te, va = split_train_test_val(mat, 0.1, 0.05, seed=seed + 1)
    return Data(train_mat=tr, test_mat=te, val_mat=va)


def _params(k: int, seed: int, **kw):
    """3-epoch training settings. ALS at k = 64 needs a flat lambda
    well above the SGD-style 0.002 (rank-8 data leaves the Grams
    near-singular and the first sweep blows up); the row-dense engine
    leaves the small-init saddle within 3 epochs at lr 0.2."""
    from matfac_tpu.config import Params
    base = dict(fac_dim=k, u_reg=0.1, i_reg=0.1, learn_rate=0.2,
                seed=seed, max_iter=3, obj_iter=1, disp_iter=1000,
                save_iter=1000)
    base.update(kw)
    return Params(**base)


def _quiet(_msg):
    pass


# ----------------------------------------------------------------------
# phase 1: train
# ----------------------------------------------------------------------

def _train_summary(rep) -> dict:
    vals = [h.val_rmse for h in rep.history]
    secs = [h.seconds for h in rep.history]
    check(len(vals) >= 3, f"{len(vals)} epochs logged, expected 3")
    check(all(np.isfinite(vals)), f"non-finite val RMSE {vals}")
    check(vals[-1] < vals[0], f"val RMSE did not fall: {vals}")
    steady = float(np.mean(secs[1:]))
    return {"engine": rep.method, "val_rmse": vals,
            "staging_s": rep.staging_seconds, "first_epoch_s": secs[0],
            "steady_epoch_s": steady,
            "compile_s_est": secs[0] - steady,
            "stop": rep.stop_reason}


def phase_train(data, k: int = K, seed: int = 0) -> dict:
    """train_model(mf, auto) must pick ALS; train_model(TMF, auto) must
    run the row-dense engine with no fallback; val RMSE falls."""
    from matfac_tpu.train.loop import train_model

    rep, model, _, _ = train_model(data, _params(k, seed), algo="mf",
                                   mf_method="auto", log_fn=_quiet)
    check(rep.method == "als", f"mf auto ran {rep.method!r}, not als")
    mf = _train_summary(rep)
    view = model.eval_view(rep.best_state)
    del rep
    rep, _, _, _ = train_model(data, _params(k, seed), algo="TMF",
                               mf_method="auto", log_fn=_quiet)
    check(rep.method == "densesgd",
          f"TMF auto ran {rep.method!r}: the dense row engine fell back")
    tmf = _train_summary(rep)
    del rep
    return {"mf": mf, "tmf": tmf, "_view": view}


# ----------------------------------------------------------------------
# phase 2: rank and serve
# ----------------------------------------------------------------------

def _zipf_users(train_mat, n: int, seed: int) -> np.ndarray:
    """``n`` users drawn Zipf(1) over users ranked by train activity."""
    deg = train_mat.row_degrees()
    order = np.argsort(-deg, kind="stable")
    p = 1.0 / np.arange(1, len(order) + 1)
    rng = np.random.default_rng(seed)
    return order[rng.choice(len(order), size=n, p=p / p.sum())]


def phase_rank_serve(data, view, k: int = K, seed: int = 0,
                     n_serve: int = 256) -> dict:
    """HR-selected dense BPR for 2 iterations, one full-catalog HR@10
    pass, and a Zipf top-10 serving batch from the trained model."""
    import jax

    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.serving import Recommender
    from matfac_tpu.train.loop import train_model
    from matfac_tpu.utils import freq

    out = {}
    p = _params(k, seed, max_iter=2, learn_rate=0.005, u_reg=0.01,
                i_reg=0.01, bpr_engine="dense")
    rep, _, _, _ = train_model(data, p, algo="bpr", mf_method="auto",
                               log_fn=_quiet)
    check(rep.method == "bpr_dense",
          f"BPR ran {rep.method!r}: the dense engine fell back")
    check(rep.stop_reason != "nonfinite_loss", "BPR loss went non-finite")
    hrs = [h.val_rmse for h in rep.history]   # TrainLoopHR logs HR here
    check(len(hrs) == 2 and all(np.isfinite(hrs)), f"BPR val HR {hrs}")
    out["bpr"] = {"engine": rep.method, "val_hr10": hrs,
                  "staging_s": rep.staging_seconds,
                  "iter_s": [h.seconds for h in rep.history]}
    del rep

    nu, ni = data.n_users, data.n_items
    iu, ii = freq.invalid_users_items(data.train_mat, nu, ni)
    scorer = CatalogScorer(data.train_mat, iu, ii, nu, ni)
    t0 = time.perf_counter()
    hr_first = scorer.hit_rate(view, data.test_mat, 10)
    t1 = time.perf_counter()
    hr = scorer.hit_rate(view, data.test_mat, 10)
    t2 = time.perf_counter()
    check(np.isfinite(hr) and 0.0 <= hr <= 1.0 and hr == hr_first,
          f"HR@10 {hr_first} then {hr}")
    out["hr10"] = {"engine": "CatalogScorer (COO exclusion, tiled "
                             "top-k)", "value": hr,
                   "first_pass_s": t1 - t0, "pass_s": t2 - t1}

    rec = Recommender(view, data.train_mat, nu, ni, iu, ii)
    users = _zipf_users(data.train_mat, n_serve, seed)
    t0 = time.perf_counter()
    items, scores = rec.recommend(users, n=10)
    t1 = time.perf_counter()
    items, scores = rec.recommend(users, n=10)
    jax.block_until_ready(scores)
    t2 = time.perf_counter()
    check(items.shape == (n_serve, 10), f"serve shape {items.shape}")
    check(np.isfinite(scores).all(), "non-finite serve scores")
    check((np.diff(scores, axis=1) <= 0).all(), "scores not descending")
    check(((items >= 0) & (items < ni)).all(), "item id out of range")
    for u, row in zip(users, items):
        rated = set(data.train_mat.row(int(u))[0].tolist())
        check(not rated.intersection(row.tolist()),
              f"user {u} served a rated item")
    out["serve"] = {"engine": "Recommender (topk_catalog_block)",
                    "users": n_serve, "distinct_users":
                    int(len(np.unique(users))),
                    "first_batch_s": t1 - t0, "batch_s": t2 - t1}
    return out


# ----------------------------------------------------------------------
# phase 2b: the CLI, end to end, in a CPU-only child process
# ----------------------------------------------------------------------

def phase_cli(data, k: int = K, seed: int = 0, timeout: int = 900) -> dict:
    """Write the data as GKlib text (data/io.py) and run
    ``python -m matfac_tpu.cli --algo mf --mf_method als`` on it. The
    child runs with --cpu, so it never opens the card this process
    holds."""
    from matfac_tpu.data.io import write_csr

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        t0 = time.perf_counter()
        for name in ("train", "test", "val"):
            paths[name] = os.path.join(tmp, f"{name}.csr")
            write_csr(getattr(data, f"{name}_mat"), paths[name])
        write_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "matfac_tpu.cli", "--cpu",
               "--algo", "mf", "--mf_method", "als",
               "--trainmat", paths["train"], "--testmat", paths["test"],
               "--valmat", paths["val"], "--facdim", str(k),
               "--maxiter", "2", "--ureg", "0.1", "--ireg", "0.1",
               "--seed", str(seed), "--prefix", os.path.join(tmp, "mf")]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=timeout)
        run_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"cli exit {proc.returncode}: {proc.stderr[-2000:]}")
    rmse = {}
    for line in proc.stdout.splitlines():
        for tag in ("Train", "Test", "Val"):
            if line.startswith(f"RE {tag} RMSE:"):
                rmse[tag.lower()] = float(line.split(":")[1])
    check(len(rmse) == 3 and all(np.isfinite(list(rmse.values()))),
          f"cli RMSE lines {rmse}")
    return {"engine": "cli --algo mf --mf_method als --cpu",
            "rmse": rmse, "write_s": write_s, "run_s": run_s}


# ----------------------------------------------------------------------
# phase 3: against the plain reference
# ----------------------------------------------------------------------

def tf32_in_effect() -> bool:
    """Whether a float32 matmul at the current precision rounds its
    operands to TF32 (10 mantissa bits): 1 + 2^-12 survives in f32 and
    is lost in TF32."""
    import jax.numpy as jnp
    a = jnp.full((512, 512), 1.0 + 2.0 ** -12, jnp.float32)
    b = jnp.ones((512, 512), jnp.float32)
    exact = 512.0 * (1.0 + 2.0 ** -12)
    return bool(abs(float(jnp.dot(a, b)[0, 0]) - exact) > 1e-3)


def _sample_users(train_mat, n: int, seed: int) -> np.ndarray:
    deg = train_mat.row_degrees()
    cand = np.nonzero(deg > 0)[0]
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(cand, size=min(n, len(cand)),
                              replace=False))


def compare_als_solves(data, k: int, seed: int, n: int = 256) -> dict:
    """Solutions of the first ALS epoch's user Grams (solvers/als.py
    _solve_bucket, Cholesky) against numpy.linalg.solve in float64."""
    import jax.numpy as jnp

    from matfac_tpu.models.base import init_state
    from matfac_tpu.solvers.als import _solve_bucket

    p = _params(k, seed)
    st = init_state(p, data.n_users, data.n_items)
    users = _sample_users(data.train_mat, n, seed)
    deg = data.train_mat.row_degrees()[users]
    cap = int(deg.max())
    cols = np.zeros((len(users), cap), np.int32)
    vals = np.zeros((len(users), cap), np.float32)
    mask = np.zeros((len(users), cap), np.float32)
    for j, u in enumerate(users):
        c, v = data.train_mat.row(int(u))
        cols[j, :len(c)], vals[j, :len(c)], mask[j, :len(c)] = c, v, 1.0
    x_dev = _solve_bucket(jnp.zeros_like(st.u_fac), st.i_fac,
                          jnp.asarray(users.astype(np.int32)),
                          jnp.asarray(cols), jnp.asarray(vals),
                          jnp.asarray(mask), float(p.u_reg))
    x_dev = np.asarray(x_dev, np.float64)[users]
    q = np.asarray(st.i_fac, np.float64)[cols]
    w = (mask * (vals > 0)).astype(np.float64)
    gram = np.einsum("bck,bcl->bkl", q * w[:, :, None], q) \
        + p.u_reg * np.eye(k)[None]
    rhs = np.einsum("bc,bck->bk", vals * w, q)
    x_ref = np.linalg.solve(gram, rhs[..., None])[..., 0]
    rel = (np.linalg.norm(x_dev - x_ref, axis=1)
           / np.maximum(np.linalg.norm(x_ref, axis=1), 1e-30))
    return {"users": len(users), "max_rel": float(rel.max()),
            "median_rel": float(np.median(rel))}


def _stripe_ref(U, I, R, Mu, Mi, lr, u_reg, i_reg, r_scale):
    """numpy float64 replica of ops/dense_block_kernel.cell_dense_update
    on int8 rating codes with TMF rank masks and collision
    normalization."""
    U, I, Mu, Mi = (np.asarray(x, np.float64) for x in (U, I, Mu, Mi))
    vm = (R != 0).astype(np.float64)
    E = vm * (R.astype(np.float64) * r_scale - (U * Mu) @ (I * Mi).T)
    gu = (-2.0 * E @ (I * Mi)) * Mu + 2.0 * u_reg * (vm @ Mi) * Mu * U
    gi = (-2.0 * E.T @ (U * Mu)) * Mi + 2.0 * i_reg * (vm.T @ Mu) * Mi * I
    gu /= np.maximum(vm.sum(1), 1.0)[:, None]
    gi /= np.maximum(vm.sum(0), 1.0)[:, None]
    return U - lr * gu, I - lr * gi


def compare_dense_stripe(data, k: int, seed: int) -> dict:
    """One row-dense stripe update (cell_dense_update, as the TMF
    engine runs it: int8 codes, rank masks, collision norm) against
    its float64 replica, with bf16 operands (the engine's mm_bf16
    default) and with f32 operands."""
    import functools

    import jax
    import jax.numpy as jnp

    from matfac_tpu.ops.dense_block_kernel import cell_dense_update

    bu = min(2560, data.n_users)
    ni = -(-data.n_items // 128) * 128
    r, c, v = data.train_mat.to_coo()
    keep = r < bu
    R = np.zeros((bu, ni), np.int8)
    R[r[keep], c[keep]] = np.round(v[keep] / 0.5).astype(np.int8)
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 0.1, (bu, k)).astype(np.float32)
    I = rng.normal(0, 0.1, (ni, k)).astype(np.float32)
    iota = np.arange(k)
    Mu = (iota[None] < rng.integers(1, k + 1, bu)[:, None]).astype(
        np.float32)
    Mi = (iota[None] < rng.integers(1, k + 1, ni)[:, None]).astype(
        np.float32)
    lr, u_reg, i_reg = 0.05, 0.002, 0.002
    u_ref, i_ref = _stripe_ref(U, I, R, Mu, Mi, lr, u_reg, i_reg, 0.5)
    out = {"rows": bu, "cols": ni}
    for tag, mm in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        fn = jax.jit(functools.partial(
            cell_dense_update, W=None, lr=jnp.float32(lr), u_reg=u_reg,
            i_reg=i_reg, collision_norm=True, mm_dtype=mm, r_scale=0.5))
        u2, i2 = fn(jnp.asarray(U), jnp.asarray(I), R=jnp.asarray(R),
                    Mu=jnp.asarray(Mu), Mi=jnp.asarray(Mi))
        du = np.asarray(u2, np.float64) - U
        di = np.asarray(i2, np.float64) - I
        out[tag] = {
            "u_rel": float(np.linalg.norm(du - (u_ref - U))
                           / np.linalg.norm(u_ref - U)),
            "i_rel": float(np.linalg.norm(di - (i_ref - I))
                           / np.linalg.norm(i_ref - I))}
    return out


def _topk_oracle(view, train_mat, invalid_items, users, n):
    """numpy float64 scores, rated + invalid items excluded, stable
    argsort; plus a per-user bound on float32 score rounding used to
    recognise ties."""
    u = np.asarray(view.u_fac, np.float64)[users]
    it = np.asarray(view.i_fac, np.float64)
    s = (u @ it.T + float(view.mu)
         + np.asarray(view.u_bias, np.float64)[users][:, None]
         + np.asarray(view.i_bias, np.float64)[None, :])
    mag = np.abs(u) @ np.abs(it).T
    s[:, invalid_items[:it.shape[0]]] = -np.inf
    for j, uid in enumerate(users):
        s[j, train_mat.row(int(uid))[0]] = -np.inf
    top = np.argsort(-s, axis=1, kind="stable")[:, :n]
    tol = 8 * 2.0 ** -24 * (mag.max(axis=1) + np.abs(s[
        np.isfinite(s)]).max())
    return s, top, tol


def _count_mismatches(ids, s, top, tol) -> int:
    """Positions whose id differs from the oracle's and whose oracle
    score differs by more than the tie tolerance."""
    bad = 0
    for j in range(len(top)):
        for pos in range(top.shape[1]):
            a, b = int(ids[j, pos]), int(top[j, pos])
            if a != b and not (0 <= a < s.shape[1]
                               and abs(s[j, a] - s[j, b]) <= tol[j]):
                bad += 1
    return bad


def compare_topk(data, view, seed: int, n_users: int = 256) -> dict:
    """Top-10 with rated-item exclusion for sampled users, through the
    serving path (padded-row exclusion) and the HR@10 path (COO
    exclusion), against the numpy argsort oracle."""
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.serving import Recommender
    from matfac_tpu.utils import freq

    nu, ni = data.n_users, data.n_items
    iu, ii = freq.invalid_users_items(data.train_mat, nu, ni)
    users = _sample_users(data.train_mat, n_users, seed + 7)
    users = users[~iu[users]]
    s, top, tol = _topk_oracle(view, data.train_mat, ii, users, 10)
    rec_ids, _ = Recommender(view, data.train_mat, nu, ni, iu,
                             ii).recommend(users, n=10)
    _, all_ids = CatalogScorer(data.train_mat, iu, ii, nu, ni).topk(
        view, 10)
    return {"users": int(len(users)),
            "serve_mismatches": _count_mismatches(rec_ids, s, top, tol),
            "catalog_mismatches": _count_mismatches(all_ids[users], s,
                                                    top, tol)}


def phase_reference(data, k: int = K, seed: int = 0) -> dict:
    """The comparisons above at the default matmul precision and under
    ``jax.default_matmul_precision("highest")``, plus 3-epoch val RMSE
    of mf/auto and TMF/auto at both precisions."""
    import jax

    from matfac_tpu.train.loop import train_model

    out = {}
    for prec in ("default", "highest"):
        ctx = (jax.default_matmul_precision("highest")
               if prec == "highest" else contextlib.nullcontext())
        with ctx:
            res = {"tf32": tf32_in_effect(),
                   "als_solve": compare_als_solves(data, k, seed),
                   "dense_stripe": compare_dense_stripe(data, k, seed)}
            rmse = {}
            view = None
            for algo in ("mf", "TMF"):
                rep, model, _, _ = train_model(
                    data, _params(k, seed), algo=algo, mf_method="auto",
                    log_fn=_quiet)
                rmse[algo] = {"engine": rep.method,
                              "val_rmse": rep.history[-1].val_rmse}
                if algo == "mf":
                    view = model.eval_view(rep.best_state)
                del rep
            res["val_rmse_3ep"] = rmse
            res["top10"] = compare_topk(data, view, seed)
        out[prec] = res

    hi, de = out["highest"], out["default"]
    fails = []
    if hi["als_solve"]["max_rel"] > ALS_HIGHEST_RTOL:
        fails.append("ALS solves at highest")
    for prec in ("default", "highest"):
        if max(out[prec]["dense_stripe"]["bf16"].values()) \
                > STRIPE_RTOL["bf16"]:
            fails.append(f"bf16 stripe update at {prec}")
        t10 = out[prec]["top10"]
        if t10["serve_mismatches"] or t10["catalog_mismatches"]:
            fails.append(f"top-10 at {prec} differs beyond ties")
    if max(hi["dense_stripe"]["f32"].values()) > STRIPE_RTOL["f32_highest"]:
        fails.append("f32 stripe update at highest")
    out["val_rmse_rel_diff"] = {}
    for algo in ("mf", "TMF"):
        a = de["val_rmse_3ep"][algo]["val_rmse"]
        b = hi["val_rmse_3ep"][algo]["val_rmse"]
        out["val_rmse_rel_diff"][algo] = abs(a - b) / b
        if not abs(a - b) <= RMSE_REL_TOL * b:
            fails.append(f"{algo} 3-epoch val RMSE default vs highest")
    out["tolerances"] = {"als_highest_rel": ALS_HIGHEST_RTOL,
                         "stripe_rel": STRIPE_RTOL,
                         "val_rmse_rel": RMSE_REL_TOL}
    out["engine"] = ("als _solve_bucket (cholesky); "
                     "dense_block_kernel.cell_dense_update; "
                     "Recommender + CatalogScorer top-k")
    out["_failures"] = fails
    return out


# ----------------------------------------------------------------------
# phase 4: determinism (recorded, never fails)
# ----------------------------------------------------------------------

def phase_determinism(data, k: int = K, seed: int = 0) -> dict:
    """Two scatter-SGD epochs from the same seed and state: XLA's GPU
    scatter-add may use atomics, so the result may differ bitwise."""
    import jax
    import jax.numpy as jnp

    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.solvers.sgd import SGDSolver
    from matfac_tpu.utils import freq

    p = _params(k, seed, learn_rate=0.005)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    model = ModelMF(p, data.n_users, data.n_items)
    solver = SGDSolver(model, p, data.train_mat, iu, ii)
    s0 = init_state(p, data.n_users, data.n_items)
    key = jax.random.PRNGKey(seed)
    outs = []
    for _ in range(2):
        st = solver.epoch(jax.tree_util.tree_map(jnp.copy, s0),
                          p.learn_rate, key)
        outs.append((np.asarray(st.u_fac), np.asarray(st.i_fac)))
    (u1, i1), (u2, i2) = outs
    return {"engine": "sgd scatter-add",
            "bitwise_equal": bool(np.array_equal(u1, u2)
                                  and np.array_equal(i1, i2)),
            "max_abs_diff": float(max(np.abs(u1 - u2).max(),
                                      np.abs(i1 - i2).max()))}


# ----------------------------------------------------------------------
# the 4-card mesh phase (--four-cards)
# ----------------------------------------------------------------------

def _device_ids(arr) -> list:
    return sorted(d.id for d in arr.sharding.device_set)


def phase_four_cards(data, k: int = K, seed: int = 0,
                     n_devices: int = 4) -> dict:
    """Row-dense block-DSGD (3 epochs) and scatter DSGD (1 epoch) on a
    4-way mesh; one sharded ALS epoch against the same epoch on one
    device; sharded HR@10 against the unsharded pass; the multi-device
    dry run."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from matfac_tpu.eval.metrics import Evaluator
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.models.base import ModelMF, init_state
    from matfac_tpu.parallel.block_dsgd import DenseBlockDSGDSolver
    from matfac_tpu.parallel.dsgd import DSGDShardedSolver
    from matfac_tpu.parallel.mesh import make_mesh, shard_state
    from matfac_tpu.solvers.als import ALSSolver
    from matfac_tpu.utils import freq

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    mesh = make_mesh((n_devices,), ("u",), devices=devices)
    nu, ni = data.n_users, data.n_items
    # plain MF on the dense engine under the rotation diverges within
    # 3 epochs at lr 0.2 from the small init; 0.05 falls steadily
    p = _params(k, seed, learn_rate=0.05)
    iu, ii = freq.invalid_users_items(data.train_mat, nu, ni)
    model = ModelMF(p, nu, ni)
    ev = Evaluator(data, iu, ii, p)
    copy = lambda st: jax.tree_util.tree_map(jnp.copy, st)  # noqa: E731
    out = {"devices": [str(d) for d in devices]}
    placement, fails = {}, []

    t0 = time.perf_counter()
    dbd = DenseBlockDSGDSolver(model, p, data.train_mat, iu, ii, mesh)
    stage_s = time.perf_counter() - t0
    placement["dense_R_tiles"] = _device_ids(dbd.R_tiles)
    st = init_state(p, nu, ni)
    vals, secs = [], []
    for e in range(3):
        t0 = time.perf_counter()
        st = dbd.epoch(st, p.learn_rate, jax.random.PRNGKey(seed + e))
        jax.block_until_ready(st)
        secs.append(time.perf_counter() - t0)
        vals.append(ev.rmse(model.eval_view(st), "val"))
    placement["dense_u_table"] = _device_ids(dbd._resident[0])
    placement["dense_i_table"] = _device_ids(dbd._resident[1])
    if not (all(np.isfinite(vals)) and vals[-1] < vals[0]):
        fails.append(f"dense block-DSGD val RMSE {vals}")
    out["dense_block_dsgd"] = {"staging_s": stage_s, "epoch_s": secs,
                               "val_rmse": vals,
                               "codes": dbd.r_scale is not None}
    view = model.eval_view(st)
    del dbd

    t0 = time.perf_counter()
    ds = DSGDShardedSolver(model, p, data.train_mat, iu, ii, mesh)
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the scatter DSGD sums colliding gradients (no collision norm), so
    # a Zipf head item takes thousands of summed steps per batch at the
    # ML-20M shape: at lr 0.005 the epoch diverges; 2e-4 stays finite
    s_ds = ds.epoch(init_state(p, nu, ni), 2e-4,
                    jax.random.PRNGKey(seed))
    jax.block_until_ready(s_ds)
    ds_s = time.perf_counter() - t0
    placement["dsgd_u_table"] = _device_ids(ds._resident[0])
    v_ds = ev.rmse(model.eval_view(s_ds), "val")
    if not np.isfinite(v_ds):
        fails.append(f"scatter DSGD val RMSE {v_ds}")
    out["dsgd"] = {"staging_s": stage_s, "epoch_s": ds_s,
                   "val_rmse": v_ds}
    del ds, s_ds

    als = ALSSolver(model, p, data.train_mat, iu, ii)
    s0 = init_state(p, nu, ni)
    with jax.default_matmul_precision("highest"):
        sh = als.epoch(shard_state(copy(s0), mesh, "u", "u"), 0.0, None)
        one = als.epoch(jax.device_put(copy(s0), devices[0]), 0.0, None)
        jax.block_until_ready((sh, one))
    placement["als_u_table"] = _device_ids(sh.u_fac)
    placement["als_i_table"] = _device_ids(sh.i_fac)
    out["als_specs"] = {"u_fac": str(sh.u_fac.sharding.spec),
                        "i_fac": str(sh.i_fac.sharding.spec)}
    rel = max(
        float(np.linalg.norm(np.asarray(a) - np.asarray(b))
              / np.linalg.norm(np.asarray(b)))
        for a, b in ((sh.u_fac, one.u_fac), (sh.i_fac, one.i_fac)))
    if not rel <= ALS_HIGHEST_RTOL:
        fails.append(f"sharded ALS epoch vs one device: {rel:.3e}")
    out["als"] = {"rel_diff_vs_one_device": rel,
                  "tolerance": ALS_HIGHEST_RTOL,
                  "precision": "highest"}
    del als, sh, one

    sharded = CatalogScorer(data.train_mat, iu, ii, nu, ni, mesh=mesh)
    single = CatalogScorer(data.train_mat, iu, ii, nu, ni)
    hr_sh = sharded.hit_rate(view, data.test_mat, 10)
    view1 = jax.device_put(view, devices[0])
    hr_1 = single.hit_rate(view1, data.test_mat, 10)
    if sharded._use_coo:
        placement["hr_exclusion_rows"] = _device_ids(sharded.ex_rows)
    # the ids of every user's top-10, not only the HR scalar (which can
    # agree by accident, e.g. at 0 on data without ranking signal)
    same = float(np.mean(sharded.topk(view, 10)[1]
                         == single.topk(view1, 10)[1]))
    if hr_sh != hr_1 or same != 1.0:
        fails.append(f"sharded HR@10 {hr_sh} vs unsharded {hr_1}; "
                     f"top-10 ids equal at {same:.6f} of positions")
    out["hr10"] = {"sharded": hr_sh, "unsharded": hr_1,
                   "top10_ids_equal_frac": same}

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices)
    out["dryrun_multichip_s"] = time.perf_counter() - t0

    fails += [f"{name} lives on devices {ids}"
              for name, ids in placement.items() if len(ids) != n_devices]
    out["device_sets"] = placement
    out["_failures"] = fails
    out["engine"] = ("DenseBlockDSGDSolver, DSGDShardedSolver, sharded "
                     "ALSSolver, sharded CatalogScorer")
    return out


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------

def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True,
                       "device": {"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(devices)}})


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return str(x)


def run_phase(name: str, fn, *args, **kw):
    """Run one phase, print its JSON line, return (ok, result). A phase
    fails by raising or by returning a non-empty ``_failures`` list
    (its numbers are printed either way); the failure is recorded and
    the run goes on, so one call reports every phase, and main() then
    exits non-zero."""
    t0 = time.perf_counter()
    try:
        res = fn(*args, **kw)
        ok = not res.get("_failures")
    except Exception as e:  # noqa: BLE001 — phase boundary, re-reported
        traceback.print_exc()
        res, ok = {"error": f"{type(e).__name__}: {e}"}, False
    line = {"phase": name, "ok": ok,
            "seconds": time.perf_counter() - t0}
    if res.get("_failures"):
        line["failures"] = res["_failures"]
    line.update({k: v for k, v in res.items() if not k.startswith("_")})
    print(json.dumps(line, default=_jsonable), flush=True)
    return ok, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices; this "
              "script has no CPU path", file=sys.stderr)
        return 2
    from matfac_tpu.utils.compile_cache import (compile_cache_dir,
                                                enable_compile_cache)
    cache = enable_compile_cache()
    print(gpu_name_and_power(), flush=True)
    n_cached = (len(os.listdir(cache)) if os.path.isdir(cache) else 0)
    print(json.dumps({"phase": "setup", "jax": jax.__version__,
                      "devices": [str(d) for d in devices],
                      "compile_cache": compile_cache_dir(),
                      "cache_entries_at_start": n_cached}), flush=True)

    t0 = time.perf_counter()
    big = make_star_data(**ML20M, seed=args.seed)
    print(json.dumps({"phase": "data", "shape": "ml20m",
                      "data": repr(big),
                      "ratings": int(big.train_mat.nnz
                                     + big.test_mat.nnz
                                     + big.val_mat.nnz),
                      "seconds": time.perf_counter() - t0}), flush=True)
    results = []
    if args.four_cards:
        results.append(run_phase("four_cards", phase_four_cards, big,
                                 K, args.seed, 4)[0])
        devices = devices[:4]
    else:
        ok, res = run_phase("train", phase_train, big, K, args.seed)
        results.append(ok)
        if ok:
            results.append(run_phase("rank_serve", phase_rank_serve, big,
                                     res["_view"], K, args.seed)[0])
        del big, res
        med = make_star_data(**MEDIUM, seed=args.seed)
        results.append(run_phase("reference", phase_reference, med, K,
                                 args.seed)[0])
        results.append(run_phase("determinism", phase_determinism, med,
                                 K, args.seed)[0])
        results.append(run_phase("cli", phase_cli, med, K,
                                 args.seed)[0])
    if not all(results):
        print(f"{results.count(False)} phase(s) failed", file=sys.stderr)
        return 1
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
