"""End-to-end tour: data -> train -> evaluate -> checkpoint -> serve.

Runs on a GPU (or, with --cpu, on the CPU) in under a minute. Mirrors
the reference's default workflow (`mf --algo mf --mf_method als ...`,
main.cpp:1233-1421) using the library surface instead of the CLI.

    PYTHONPATH=/path/to/repo python examples/train_eval_serve.py [--cpu]
"""

import argparse
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description="train -> eval -> serve")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the GPU")
    args = ap.parse_args(argv)
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU found ({jax.devices()[0].platform}); pass "
                 "--cpu to run on the CPU")
    from matfac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # --- 1. data ---------------------------------------------------
    # GKlib-text CSR files load through Params/Data exactly like the
    # reference (datastruct.cpp:3-120). Here we synthesize a low-rank
    # problem and split it, the reference's own validation methodology
    # (python/genLatFacs.py, --origufac/--origifac).
    from matfac_tpu.config import Params
    from matfac_tpu.data.io import split_train_test_val, write_csr
    from matfac_tpu.data.synthetic import low_rank_ratings

    n_users, n_items = 1500, 600
    full, true_u, true_i = low_rank_ratings(
        n_users, n_items, k=8, density=0.05, seed=7, noise=0.05,
        power_law=0.5, nonneg=True)
    train, test, val = split_train_test_val(full, test_pc=0.1,
                                            val_pc=0.1, seed=3)

    workdir = tempfile.mkdtemp(prefix="matfac_example_")
    paths = {}
    for name, m in (("train", train), ("test", test), ("val", val)):
        paths[name] = os.path.join(workdir, f"{name}.csr")
        write_csr(m, paths[name])

    params = Params(fac_dim=16, u_reg=0.01, i_reg=0.01,
                    learn_rate=0.01, max_iter=30, seed=1,
                    train_mat_file=paths["train"],
                    test_mat_file=paths["test"],
                    val_mat_file=paths["val"],
                    prefix=os.path.join(workdir, "mf"),
                    disp_iter=10)
    print(params.display())

    from matfac_tpu.data.dataset import Data
    data = Data(params)
    print(data)

    # --- 2. train (ALS; swap mf_method for sgd/blocksgd/ccd++/...) --
    from matfac_tpu.train.loop import train_model
    report, model, evaluator, (inval_u, inval_i) = train_model(
        data, params, algo="mf", mf_method="als",
        prefix=params.prefix)
    print(f"best val RMSE {report.best_metric:.4f} "
          f"at epoch {report.best_iter} ({report.stop_reason})")

    # --- 3. evaluate -------------------------------------------------
    view = model.eval_view(report.best_state)
    print(f"test RMSE   {evaluator.rmse(view, 'test'):.4f}")
    print(f"test NDCG@10 {evaluator.ndcg(view, 'test'):.4f}")

    from matfac_tpu.eval.quartile import quartile_report
    print(quartile_report(view, data, evaluator, inval_u, inval_i))

    # synthetic-recovery check against the generating factors
    # (fullLowRankErr, model.cpp:1942)
    err = evaluator.full_low_rank_err(view, true_u, true_i)
    print(f"recovery error vs ground-truth factors: {err:.4f}")

    # --- 4. serve ----------------------------------------------------
    # train_model already checkpointed the best factors under
    # prefix_uFac_<signature>.mat (model.cpp:89-101 protocol)
    from matfac_tpu.serving import Recommender
    rec = Recommender.from_checkpoint(params.prefix, params, data)
    users = [0, 1, 2]
    items, scores = rec.recommend(users, n=5)
    for u, it in zip(users, items):
        print(f"user {u}: top-5 items {list(it)}")
    print(f"(artifacts in {workdir})")


if __name__ == "__main__":
    main()
