"""The port's IBMIL and its confounder pipeline against the JAX package on
the CPU: logits and every gradient without confounders, with (P, 512)
prototypes, and with a small injected R2T encoder (c16_r50's encoder at
one R-MSA layer, --only_rrt_enc); `pca_whiten`; `kmeans` and
`build_confounders` on well-separated clusters; `python -m
rrtmil_tpu_torch.build_confounders` (one .npy per fold, where `--model
ibmil --confounder_path` reads it, then that CLI run); and two dropout-off
train steps through the classification harness's pieces against the JAX
harness's, the prototypes loaded from their file on both sides.

Weights: the port's seeded init carried to JAX by convert.py.
Tolerances: logits and gradients 1e-5 of max(1, max|jax|) (1e-4 with the
encoder, whose kernels' plain versions sum in other orders, as
tests/test_torch_zoo_rrt.py holds them); pca_whiten 1e-6; prototypes
1e-5 after matching the clusters; train losses 1e-4.  The k-means++
seeding draws from a torch.Generator on one side and a JAX key on the
other, so the clusters are compared up to a permutation, on data where
every seeding finds the same partition.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import main as jcli
from rrtmil_tpu.config import c16_r50 as jax_c16_r50
from rrtmil_tpu.data import confounders as jconf
from rrtmil_tpu.data.bucketing import bucket_for
from rrtmil_tpu.data.datasets import ArrayDataset as JArrayDataset
from rrtmil_tpu.harness import classification as jclassification
from rrtmil_tpu.models.ibmil import IBMIL as JIBMIL
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu.train.engine import TrainState
from rrtmil_tpu_torch import build_confounders as confounder_cli
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch.config import c16_r50
from rrtmil_tpu_torch.convert import flax_to_torch, torch_to_flax
from rrtmil_tpu_torch.data import confounders
from rrtmil_tpu_torch.data.datasets import ArrayDataset
from rrtmil_tpu_torch.harness import classification
from rrtmil_tpu_torch.models import zoo
from rrtmil_tpu_torch.train.engine import Engine

from test_torch_harness import _args, _write_c16

D_IN = 32


def close(got, want, what, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: scaled error {err:.3e}"


def prototypes(p=4, seed=9):
    return np.random.default_rng(seed).standard_normal((p, 512)) \
        .astype(np.float32)


def as_tuple(conf):
    return None if conf is None else tuple(map(tuple, conf.tolist()))


@pytest.mark.parametrize("with_conf,with_enc,n",
                         [(False, False, 150), (True, False, 150),
                          (True, True, 200)])
def test_logits_and_gradients_match_jax(with_conf, with_enc, n):
    conf = prototypes() if with_conf else None
    enc = jenc = None
    if with_enc:
        enc = dataclasses.replace(c16_r50().encoder, backend="auto",
                                  mm_dtype="float32", dropout=0.0)
        jenc = dataclasses.replace(jax_c16_r50().encoder, backend="xla",
                                   mm_dtype="float32", dropout=0.0)
    tol = 1e-4 if with_enc else 1e-5
    model = zoo.build_model("ibmil", input_dim=D_IN, dropout=0.0,
                            rrt_cfg=enc, confounders=conf, device="cpu",
                            seed=n)
    assert "confounders" not in model.state_dict()
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    jmodel = JIBMIL(input_dim=D_IN, dropout=0.0, rrt=jenc,
                    confounders=as_tuple(conf))
    spec = bucket_for(n, jenc or jax_c16_r50().encoder)
    rng = np.random.default_rng(n)
    x = np.zeros((1, spec.data_length, D_IN), np.float32)
    x[0, :n] = rng.standard_normal((n, D_IN))
    mask = np.zeros((1, spec.data_length), bool)
    mask[0, :n] = True

    def jloss(p):
        lg = jmodel.apply({"params": p}, jnp.asarray(x),
                          mask=jnp.asarray(mask), length=spec.repr_length,
                          deterministic=True)
        return -jax.nn.log_softmax(lg, -1)[0, 1], lg

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    logits = model(torch.from_numpy(x), mask=torch.from_numpy(mask),
                   length=spec.repr_length)
    close(logits.detach().numpy(), jlogits, "logits", tol)
    loss = -torch.log_softmax(logits, -1)[0, 1]
    loss.backward()
    want = flax_to_torch(jgrads)
    assert set(want) == {k for k, _ in model.named_parameters()}
    assert ("W_q.weight" in want) == with_conf
    for name, p in model.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), f"{name} grad", tol)


def clusters(k=4, per=12, d=24, seed=0):
    """k tight clusters far apart, shuffled."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)) * 20
    x = np.concatenate([c + 0.05 * rng.standard_normal((per, d))
                        for c in centres]).astype(np.float32)
    perm = rng.permutation(len(x))
    return x[perm], np.repeat(np.arange(k), per)[perm]


def matched(got, want):
    """`got`'s rows reordered to `want`'s by nearest row."""
    order = [int(np.argmin(((got - w) ** 2).sum(1))) for w in want]
    assert sorted(order) == list(range(len(want)))
    return got[order]


def test_pca_whiten_matches_jax():
    x = np.random.default_rng(1).standard_normal((40, 16)) \
        .astype(np.float32)
    np.testing.assert_allclose(confounders.pca_whiten(x),
                               jconf.pca_whiten(x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(confounders.pca_whiten(x, dim_out=5),
                               jconf.pca_whiten(x, dim_out=5), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_finds_jax_partition(seed):
    x, truth = clusters(seed=seed)
    got = confounders.kmeans(x, 4, torch.Generator().manual_seed(seed)) \
        .numpy()
    want = np.asarray(jconf.kmeans(jnp.asarray(x), 4, seed=seed))
    got = matched(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assign = ((x[:, None] - got[None]) ** 2).sum(-1).argmin(1)
    jassign = ((x[:, None] - want[None]) ** 2).sum(-1).argmin(1)
    assert np.array_equal(assign, jassign)
    assert len({(a, t) for a, t in zip(assign, truth)}) == 4


def test_kmeans_refuses_more_clusters_than_points():
    """k-means++ cannot seed more clusters than there are distinct points
    (the CLI's k against a fold's training bags): a clear error."""
    with pytest.raises(ValueError, match="3 points into 4 clusters"):
        confounders.kmeans(np.eye(3, 8, dtype=np.float32), 4,
                           torch.Generator().manual_seed(0))


def test_build_confounders_matches_jax_up_to_a_permutation():
    """Clustered in the whitened space, averaged in the original one.  Two
    features: whitening puts every direction at unit variance, so with
    more features than clusters the within-cluster noise would weigh as
    much as the cluster centres' spread."""
    x, truth = clusters(k=3, per=15, d=2, seed=4)
    got = confounders.build_confounders(x, 3, torch.Generator()
                                        .manual_seed(2))
    want = jconf.build_confounders(x, k=3, seed=2)
    got = matched(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    means = np.stack([x[truth == c].mean(0) for c in range(3)])
    np.testing.assert_allclose(matched(means, want), want, rtol=0,
                               atol=1e-5)


def test_confounder_cli_writes_each_folds_prototypes_where_ibmil_reads(
        tmp_path):
    """`python -m rrtmil_tpu_torch.build_confounders` on a 2-fold set: one
    (k, 512) file per fold at `confounder_file`'s path, the folds' files
    differing; then `--model ibmil --confounder_path` trains on them."""
    root = tmp_path / "data"
    _write_c16(str(root), n=8)
    common = ["--dataset_root", str(root), "--input_dim", str(D_IN),
              "--cv_fold", "2", "--num_epoch", "1", "--confounder_k", "3",
              "--device", "cpu"]
    out = str(tmp_path / "conf")
    paths = confounder_cli.main(common + ["--confounder_out", out,
                                   "--confounder_epochs", "1",
                                   "--model_path", str(tmp_path / "m1")])
    args = cli.postprocess_args(cli.build_parser().parse_args(
        common + ["--model", "ibmil", "--confounder_path", out,
                  "--model_path", str(tmp_path / "m2")]))
    assert paths == [classification.confounder_file(args, f)
                     for f in range(2)]
    protos = [np.load(p) for p in paths]
    assert all(p.shape == (3, 512) and np.isfinite(p).all() for p in protos)
    assert not np.allclose(protos[0], protos[1])
    built = []
    orig = classification.build_model_from_args

    def build(a, device, **kw):
        out_ = orig(a, device, **kw)
        built.append(out_[0])
        return out_
    classification.build_model_from_args = build
    try:
        metrics = cli.main(common + ["--model", "ibmil", "--confounder_path",
                                     out, "--model_path",
                                     str(tmp_path / "m2")])
    finally:
        classification.build_model_from_args = orig
    assert len(metrics["auc"]) == 2 and np.isfinite(metrics["auc"]).all()
    for model, p in zip(built, protos):
        assert np.array_equal(model.confounders.numpy(), p)


def test_two_train_steps_through_the_harness_match_jax(tmp_path):
    """--model ibmil --confounder_path FILE, dropout 0: two batch-1 Adam
    steps from the same weights, each harness's model (prototypes loaded
    from the file) and engine config; the mean loss within 1e-4, every
    parameter within Adam's drift bound, the evaluate within 1e-4."""
    path = str(tmp_path / "protos.npy")
    np.save(path, prototypes(5, seed=3))
    over = dict(model="ibmil", dropout=0.0, input_dim=D_IN,
                patch_shuffle=False, confounder_path=path)
    rng = np.random.default_rng(8)
    train = [rng.standard_normal((n, D_IN)).astype(np.float32)
             for n in (150, 220)]
    labels = [1, 0]
    jargs = _args(jcli, tmp_path, "jax", **over)
    jmodel, jenc = jclassification.build_model_from_args(
        jargs, confounders=as_tuple(np.load(path)))
    jcfg = jclassification.engine_config_from_args(jargs)
    jcfg.num_workers = 0
    jeng = JEngine(jmodel, jcfg, encoder_cfg=jenc)

    args = _args(cli, tmp_path, "port", device="cpu", **over)
    model, enc = classification.build_model_from_args(
        args, "cpu", confounders=np.load(classification.confounder_file(
            args, 0)))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    state = TrainState(params=params, opt_state=jeng.tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, jloss = jeng.train_epoch(state, JArrayDataset(train, labels), 0,
                                    jax.random.PRNGKey(0), order=[0, 1])
    jprobs, _, jeval = jeng.evaluate(state.params,
                                     JArrayDataset(train, labels))
    ecfg = classification.engine_config_from_args(args)
    eng = Engine(model, ecfg, enc, device="cpu")
    loss = eng.train_epoch(ArrayDataset(train, labels), 0, order=[0, 1])
    assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss)), (loss, jloss)
    want = flax_to_torch(state.params)
    for name, p in eng.model.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        diff = np.abs(p.detach().numpy() - ref) / scale
        assert diff.max() <= 2 * 2 * ecfg.lr * 1.01 / scale, name
        # these biases shift a whole softmax row (attention over the bag,
        # over the prototypes): their gradients are rounding noise
        if name not in ("attn_fc2.bias", "W_k.bias"):
            assert (diff > 1e-5 + 1e-4 * np.abs(ref) / scale).mean() \
                <= 1e-3, name
    probs, _, ev = eng.evaluate(ArrayDataset(train, labels))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-4)
    assert abs(ev - jeval) <= 1e-4


def test_extract_bag_features_is_the_pooled_embedding():
    model = zoo.build_model("attmil", input_dim=D_IN, device="cpu", seed=1)
    rng = np.random.default_rng(2)
    ds = ArrayDataset([rng.standard_normal((n, D_IN)).astype(np.float32)
                       for n in (10, 70)], [0, 1])
    feats = confounders.extract_bag_features(model, ds)
    assert feats.shape == (2, 512)
    with torch.no_grad():
        _, m = model(torch.from_numpy(ds[1][0][None]), return_pooled=True)
    np.testing.assert_allclose(feats[1], m[0].numpy(), rtol=0, atol=1e-6)
    assert not model.training


def test_ibmil_with_the_encoder_and_the_survival_cli(tmp_path):
    """`--model ibmil --only_rrt_enc` (no prototypes) through the
    classification CLI, 2 folds x 1 epoch, and `survival_main --model
    IBMIL`, 5 folds x 1 epoch, on the CPU."""
    from rrtmil_tpu_torch import survival_main as scli

    from test_torch_survival_cli import _write_survival_csv
    _write_c16(str(tmp_path / "c16"), n=8)
    metrics = cli.main(["--model", "ibmil", "--only_rrt_enc",
                        "--dataset_root", str(tmp_path / "c16"),
                        "--model_path", str(tmp_path / "m"), "--input_dim",
                        str(D_IN), "--cv_fold", "2", "--num_epoch", "1",
                        "--crmsa_k", "1", "--epeg_k", "9", "--device",
                        "cpu"])
    assert all(np.isfinite(metrics[k]).all() and len(metrics[k]) == 2
               for k in ("acs", "auc", "pre", "rec", "fs"))
    csv_file = _write_survival_csv(str(tmp_path / "surv"))
    meter = scli.main(["--excel_file", csv_file, "--results_dir",
                       str(tmp_path / "s"), "--model", "IBMIL",
                       "--input_dim", "32", "--num_epoch", "1", "--device",
                       "cpu"])
    assert all(np.isfinite(c) for c in meter.cindex[1:])
