"""Command-line driver — flag parity with the reference gflags CLI
(/root/reference/main.cpp:26-73).

Usage:
  python -m matfac_tpu.cli --algo mf --mf_method sgd \
      --trainmat train.csr --testmat test.csr --valmat val.csr \
      --facdim 10 --maxiter 500 --ureg 0.01 --ireg 0.01 \
      --learnrate 0.005 --seed 1 --prefix out/mf

After training it reports final Train/Test/Val RMSE and the quartile
breakdowns (main.cpp:1377-1413 equivalent).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from matfac_tpu.config import Params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="matfac_tpu",
        description="JAX matrix factorization (reference-parity CLI)")
    # names mirror main.cpp:26-46 gflags
    ap.add_argument("--algo", default="mf",
                    help="mf | mf_bias | IFWMF | TMF | TMFDropout | "
                         "tmf_bias | mf_headwt | mf_loc | mf_freq | "
                         "dropoutmf[_ordered|_onlyordered] | "
                         "bpr | bprPoissonDropout | "
                         "increment (increment needs --graphmat as "
                         "the probe set; mf_headwt/mf_loc/mf_freq/"
                         "tmf_bias/dropoutmf = othersrc ModelMFWt "
                         "head-item down-weighting / ModelMFLoc tail "
                         "half-rank / ModelMFFreq head-first "
                         "curriculum / ModelDropoutMFBias / "
                         "ModelDropoutMF soft three-tier adaptive rank)")
    ap.add_argument("--mf_method", default="sgd",
                    help="sgd|sgdpar|sgdparsvd|sgdu|hogsgd|blocksgd|"
                         "densesgd|als|"
                         "ialspp|alsdense|ccd|ccd++|ccd++freqadap|auto "
                         "(auto = choice by input properties). "
                         "For --algo bpr*: train|hog|posneg|sigmoid|auto "
                         "(train/hog = stream + HR selection, posneg = "
                         "per-user pos/neg pairs + NDCG selection, "
                         "sigmoid = deterministic-rank BPRPoisson)")
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--facdim", type=int, default=10)
    ap.add_argument("--svdfacdim", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ureg", type=float, default=0.01)
    ap.add_argument("--ireg", type=float, default=0.01)
    ap.add_argument("--learnrate", type=float, default=0.005)
    ap.add_argument("--rhorms", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--regexponent", type=float, default=0.0,
                    help="frequency-scaled regularization: per-entity "
                         "lambda = reg * freq^e (0 = flat; othersrc "
                         "WtReg / iALS scaled-lambda)")
    ap.add_argument("--trainmat", required=True)
    ap.add_argument("--testmat", required=True)
    ap.add_argument("--valmat", required=True)
    ap.add_argument("--graphmat", default=None)
    ap.add_argument("--origufac", default=None)
    ap.add_argument("--origifac", default=None)
    ap.add_argument("--initufac", default=None)
    ap.add_argument("--initifac", default=None)
    ap.add_argument("--prefix", default="mf")
    # extras without a reference flag
    ap.add_argument("--batchsize", type=int, default=16384)
    ap.add_argument("--bprsampler", default="rankgap",
                    choices=["rankgap", "gap"],
                    help="BPR negative sampler (PERF.md 'BPR pairwise')")
    ap.add_argument("--bprtries", type=int, default=2,
                    help="BPR sampler tries per positive (failures "
                         "drop with weight 0)")
    ap.add_argument("--bprengine", default="stream",
                    choices=["stream", "dense"],
                    help="BPR epoch engine (dense = stripe score "
                         "panels, solvers/bpr_dense.py)")
    ap.add_argument("--ccdgroup", type=int, default=1,
                    help="CCD++ rank-g block sweeps (g dims solved "
                         "jointly; README deviation #14)")
    ap.add_argument("--svdinit", action="store_true",
                    help="initialize factors from truncated SVD")
    ap.add_argument("--quartiles", action="store_true", default=True)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--resume", action="store_true",
                    help="continue from {prefix}_loop.npz if present "
                         "(bit-exact resume incl. PRNG key chain)")
    ap.add_argument("--mode", default="train",
                    choices=["train", "analyze"],
                    help="analyze = offline analysis of saved factors "
                         "(computeSampTopNFrmFullModel path, "
                         "main.cpp:75-396)")
    return ap


def _run_analyze(args, params, data):
    """Offline analysis: load trained factors (--initufac/--initifac),
    optional ground truth (--origufac/--origifac), run freq-RMSE sweeps,
    top-bucket curves and PPR/GPR comparison."""
    import jax.numpy as jnp

    from matfac_tpu.analysis.drivers import (compare_ppr_gpr,
                                             sample_top_n_analysis)
    from matfac_tpu.data.io import item_cosine_sim, read_factor_mat
    from matfac_tpu.eval.metrics import Evaluator
    from matfac_tpu.models.base import EvalView
    from matfac_tpu.ops.ppr import PPREngine
    from matfac_tpu.ops.svd_init import svd_init
    from matfac_tpu.utils import freq as ufreq

    if not (args.initufac and args.initifac):
        raise SystemExit("--mode analyze needs --initufac/--initifac "
                         "(the trained factors)")
    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    ev = Evaluator(data, inval_u, inval_i, params)

    def view_of(u, i):
        return EvalView(jnp.asarray(u), jnp.asarray(i),
                        jnp.zeros(data.n_users), jnp.zeros(data.n_items),
                        jnp.float32(0))

    full = view_of(read_factor_mat(args.initufac, data.n_users,
                                   params.fac_dim),
                   read_factor_mat(args.initifac, data.n_items,
                                   params.fac_dim))
    print(f"Loaded model: Train RMSE {ev.rmse(full, 'train'):.6f} "
          f"Test RMSE {ev.rmse(full, 'test'):.6f}")

    orig = full
    if data.orig_u_fac is not None and data.orig_i_fac is not None:
        orig = view_of(data.orig_u_fac, data.orig_i_fac)
        print(f"fullLowRankErr vs ground truth: "
              f"{ev.full_low_rank_err(full, data.orig_u_fac, data.orig_i_fac):.6f}")

    su, sv, _ = svd_init(data.train_mat, params.svd_fac_dim,
                         sparsity_only=True)
    svd_view = view_of(su, sv)
    if data.graph_mat is not None:
        eng = PPREngine(data.graph_mat)
    else:
        eng = PPREngine(item_cosine_sim(data.train_mat, top_k=50))
    rep = sample_top_n_analysis(full, orig, ev, data, inval_u, inval_i,
                                svd_view=svd_view, ppr_engine=eng,
                                n_users=min(200, data.n_users),
                                seed=params.seed)
    print("Freq-RMSE sweep (top-p items): ")
    for p, (cnt, rmse) in rep["freq_rmse_sweep"].items():
        print(f"  top {p:.0%}: n={cnt} rmse={rmse:.6f}")
    print("Per-user bucket RMSE curves (bucket 0 = top-scored):")
    for name, curve in rep["bucket_curves"].items():
        print(f"  {name}: " + " ".join(f"{x:.4f}" for x in curve))
    users = np.random.default_rng(params.seed).choice(
        data.n_users, size=min(50, data.n_users), replace=False)
    ov = compare_ppr_gpr(eng, data.train_mat, users)
    print(f"PPR-vs-GPR top-100 mean overlap: {ov['mean_overlap']:.4f}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    params = Params(
        fac_dim=args.facdim, max_iter=args.maxiter,
        svd_fac_dim=args.svdfacdim, seed=args.seed, u_reg=args.ureg,
        i_reg=args.ireg, learn_rate=args.learnrate, rho_rms=args.rhorms,
        alpha=args.alpha, reg_exponent=args.regexponent,
        train_mat_file=args.trainmat,
        test_mat_file=args.testmat, val_mat_file=args.valmat,
        graph_mat_file=args.graphmat, orig_u_fac_file=args.origufac,
        orig_i_fac_file=args.origifac, init_u_fac_file=args.initufac,
        init_i_fac_file=args.initifac, prefix=args.prefix,
        batch_size=args.batchsize, bpr_sampler=args.bprsampler,
        n_negatives=args.bprtries, bpr_engine=args.bprengine,
        ccd_group_dims=args.ccdgroup)
    print(params.display())

    from matfac_tpu.data.dataset import Data
    from matfac_tpu.data.io import read_factor_mat
    from matfac_tpu.models.base import init_state
    from matfac_tpu.train.loop import train_model

    data = Data(params)
    print(data)

    if args.mode == "analyze":
        return _run_analyze(args, params, data)

    init_override = None
    if args.initufac and args.initifac:
        import jax.numpy as jnp
        st = init_state(params, data.n_users, data.n_items)
        init_override = st._replace(
            u_fac=jnp.asarray(read_factor_mat(
                args.initufac, data.n_users, params.fac_dim)),
            i_fac=jnp.asarray(read_factor_mat(
                args.initifac, data.n_items, params.fac_dim)))
    elif args.svdinit:
        import jax.numpy as jnp
        from matfac_tpu.ops.svd_init import svd_init
        from matfac_tpu.train.loop import _pad_rows
        u, v, s = svd_init(data.train_mat, params.fac_dim)
        st = init_state(params, data.n_users, data.n_items)
        u = _pad_rows(u, data.n_users)
        v = _pad_rows(v, data.n_items)
        init_override = st._replace(u_fac=jnp.asarray(u),
                                    i_fac=jnp.asarray(v))

    report, model, ev, (inval_u, inval_i) = train_model(
        data, params, algo=args.algo, mf_method=args.mf_method,
        init_state_override=init_override, prefix=args.prefix,
        resume=args.resume)

    best = report.best_state
    view = model.eval_view(best)
    is_ranking = getattr(model, "is_ranking", False)
    if is_ranking:
        scorer = ev  # _train_ranking returns the CatalogScorer
        print(f"\nBest val HR@10: {report.best_metric:.6f}")
        print(f"Test HR@10: "
              f"{scorer.hit_rate(view, data.test_mat, 10):.6f}")
        print(f"Test ARHR: {scorer.arhr(view, data.test_mat):.6f}")
    else:
        # final RMSE report (main.cpp:1377-1382)
        print(f"\nRE Train RMSE: {ev.rmse(view, 'train'):.6f}")
        print(f"RE Test RMSE: {ev.rmse(view, 'test'):.6f}")
        print(f"RE Val RMSE: {ev.rmse(view, 'val'):.6f}")
        if args.quartiles:
            from matfac_tpu.eval.quartile import quartile_report
            print(quartile_report(view, data, ev, inval_u, inval_i))
        inc = getattr(report, "increment", None)
        if inc is not None:
            print(f"increment ranks: user mean {inc.rank_u.mean():.2f} "
                  f"max {int(inc.rank_u.max())} | item mean "
                  f"{inc.rank_i.mean():.2f} max {int(inc.rank_i.max())}")
    print(f"stop: {report.stop_reason} best_iter: {report.best_iter}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
