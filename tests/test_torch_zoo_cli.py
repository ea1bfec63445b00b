"""The zoo through both CLIs on the CPU: `run_cv` for DSMIL with
--ds_average against the JAX package's `run_cv`, every zoo model with and
without --only_rrt_enc through `python -m rrtmil_tpu_torch.main`'s
`main(argv)`, CLAM's camelyon16 / TCGA subtyping switch and forced engine
settings, `--dsmil_init`, and AttMIL, CLAM_SB, CLAM_MB and DSMIL through
the survival CLI.

The parity run starts each fold from JAX's initial weights (dropout 0)
and holds every evaluate's probabilities and mean loss to 1e-4 and the
five scores to equality, as tests/test_torch_harness.py holds rrtmil's.
"""
import os

import numpy as np
import pytest
import torch

import jax

import main as jcli
from rrtmil_tpu.harness import classification as jclassification
from rrtmil_tpu.train.engine import Engine as JEngine
from rrtmil_tpu_torch import main as cli
from rrtmil_tpu_torch import survival_main as scli
from rrtmil_tpu_torch.convert import flax_to_torch
from rrtmil_tpu_torch.harness import classification
from rrtmil_tpu_torch.models.clam import CLAM_SB
from rrtmil_tpu_torch.models.dsmil import DSMIL
from rrtmil_tpu_torch.train.engine import Engine

from test_torch_harness import _args, _recording, _write_c16
from test_torch_survival_cli import _write_survival_csv

D_IN = 32
ZOO = ("attmil", "gattmil", "clam_sb", "clam_mb", "dsmil")


def test_dsmil_ds_average_run_cv_matches_jax(tmp_path, monkeypatch):
    """DSMIL --ds_average, 2 folds x 2 epochs, dropout 0: the engines take
    0.5 / 0.5 loss weights, batch size 1 and the max-instance criterion;
    every evaluate and the five scores as JAX's."""
    _write_c16(str(tmp_path / "data"))
    over = dict(model="dsmil", ds_average=True, dropout=0.0,
                patch_shuffle=False, batch_size=2)
    jinit, jevals, evals = [], [], []
    orig_init = JEngine.init

    def init(self, *a, **k):
        state = orig_init(self, *a, **k)
        jinit.append(jax.tree.map(np.array, state.params))
        return state
    monkeypatch.setattr(JEngine, "init", init)
    monkeypatch.setattr(JEngine, "evaluate", _recording(JEngine, jevals))
    jmetrics = jclassification.run_cv(_args(jcli, tmp_path, "jax", **over))

    orig_build = classification.build_model_from_args

    def build(args, device):
        model, enc = orig_build(args, device)
        model.load_state_dict(flax_to_torch(jinit[0]))
        return model, enc
    monkeypatch.setattr(classification, "build_model_from_args", build)
    monkeypatch.setattr(Engine, "evaluate", _recording(Engine, evals))
    args = _args(cli, tmp_path, "port", device="cpu", **over)
    ecfg = classification.engine_config_from_args(args)
    assert (ecfg.batch_size, ecfg.cls_alpha, ecfg.aux_alpha, ecfg.aux_mode,
            ecfg.ds_average) == (1, 0.5, 0.5, "logits", True)
    metrics = classification.run_cv(args)
    assert len(evals) == len(jevals) == 2 * 3
    for (p, l, loss), (jp, jl, jloss) in zip(evals, jevals):
        assert l.tolist() == jl.tolist()
        np.testing.assert_allclose(p, jp, rtol=0, atol=1e-4)
        assert abs(loss - jloss) <= 1e-4
    for key in ("acs", "auc", "pre", "rec", "fs"):
        assert metrics[key] == jmetrics[key], key


@pytest.fixture(scope="module")
def c16(tmp_path_factory):
    root = tmp_path_factory.mktemp("c16")
    _write_c16(str(root / "data"), n=8)
    return root


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("enc", [False, True])
def test_cli_trains_and_evaluates_each_zoo_model(c16, tmp_path, name, enc):
    """`main(argv)` on the CPU, 2 folds x 1 epoch: finite metrics, both
    checkpoint families, the encoder in the model exactly when asked for."""
    built = []
    orig = classification.build_model_from_args

    def build(args, device):
        out = orig(args, device)
        built.append(out[0])
        return out
    classification.build_model_from_args = build
    try:
        argv = ["--model", name, "--dataset_root", str(c16 / "data"),
                "--model_path", str(tmp_path), "--input_dim", str(D_IN),
                "--cv_fold", "2", "--num_epoch", "1", "--crmsa_k", "1",
                "--epeg_k", "9", "--device", "cpu", "--log_iter", "1"]
        metrics = cli.main(argv + (["--only_rrt_enc"] if enc else []))
    finally:
        classification.build_model_from_args = orig
    assert len(built) == 2
    has_rrt = any(n.split(".")[0] == "rrt" or ".rrt." in n
                  for n, _ in built[0].named_parameters())
    assert has_rrt == enc
    assert all(np.isfinite(metrics[k]).all() and len(metrics[k]) == 2
               for k in ("acs", "auc", "pre", "rec", "fs"))
    out = os.path.join(str(tmp_path), "mil_new_c16", "default")
    assert {"ckp.pt", "ckp_host.pkl"} <= set(os.listdir(out))


def test_clam_subtyping_follows_the_dataset(tmp_path):
    """camelyon16 turns CLAM's subtyping off (main.py's harness), TCGA on;
    CLAM and DSMIL train one bag at a time whatever --batch_size says."""
    for datasets, want in (("camelyon16", False), ("tcga", True)):
        args = cli.postprocess_args(cli.build_parser().parse_args(
            ["--model", "clam_mb", "--datasets", datasets, "--batch_size",
             "4", "--input_dim", str(D_IN), "--model_path", str(tmp_path),
             "--device", "cpu", "--only_rrt_enc"]))
        model, enc = classification.build_model_from_args(args, "cpu")
        assert model.subtyping == want and model.rrt is not None
        assert enc.region_num == args.region_num
        ecfg = classification.engine_config_from_args(args)
        assert (ecfg.batch_size, ecfg.cls_alpha, ecfg.aux_alpha,
                ecfg.aux_mode) == (1, 0.7, 0.3, "loss")
    args = cli.postprocess_args(cli.build_parser().parse_args(
        ["--model", "attmil", "--batch_size", "4", "--model_path",
         str(tmp_path)]))
    assert classification.engine_config_from_args(args).batch_size == 4


def test_dsmil_init_flag_loads_the_warm_start(c16, tmp_path):
    """--dsmil_init: every fold's model starts from the file's q weights
    (a .pth the test writes)."""
    q = torch.nn.Linear(512, 128)
    path = str(tmp_path / "init.pth")
    torch.save({"b_classifier.q.weight": q.weight.detach(),
                "b_classifier.q.bias": q.bias.detach()}, path)
    seen = []
    orig = Engine.__init__

    def init(self, model, *a, **k):
        assert isinstance(model, DSMIL)
        orig(self, model, *a, **k)
        seen.append(self)
    Engine.__init__ = init
    orig_train = Engine.train_epoch

    def train(self, *a, **k):
        if not hasattr(self, "_checked"):
            self._checked = torch.equal(
                self.model.b_classifier.q.weight.detach(), q.weight.detach())
        return orig_train(self, *a, **k)
    Engine.train_epoch = train
    try:
        cli.main(["--model", "dsmil", "--dsmil_init", path,
                  "--dataset_root", str(c16 / "data"), "--model_path",
                  str(tmp_path), "--input_dim", str(D_IN), "--cv_fold", "2",
                  "--num_epoch", "1", "--device", "cpu"])
    finally:
        Engine.__init__, Engine.train_epoch = orig, orig_train
    assert len(seen) == 2 and all(e._checked for e in seen)


@pytest.mark.parametrize("name", ["AttMIL", "CLAM_SB", "CLAM_MB", "DSMIL"])
def test_survival_cli_trains_each_zoo_backbone(tmp_path, name):
    """`python -m rrtmil_tpu_torch.survival_main --model {name}` on the CPU,
    5 folds x 1 epoch: the results CSV and finite c-indices."""
    csv_file = _write_survival_csv(str(tmp_path / "data"))
    out = str(tmp_path / "out")
    meter = scli.main(["--excel_file", csv_file, "--results_dir", out,
                       "--model", name, "--input_dim", str(D_IN),
                       "--num_epoch", "1", "--device", "cpu"])
    assert len(meter.cindex) == 1 + 5 + 2
    assert all(np.isfinite(c) for c in meter.cindex[1:])
    assert os.path.exists(os.path.join(out, f"results_{name}.csv"))


def test_clam_eval_forward_leaves_the_instance_loss_out():
    model = CLAM_SB(input_dim=D_IN)
    out = model(torch.randn(1, 40, D_IN))
    assert torch.is_tensor(out) and out.shape == (1, 2)
