"""The port's side of the sequence-sharded CPU tests, run on every rank of a
gloo process group (`rrtmil_tpu_torch.parallel.mesh.launch`): each case of
the input file runs on every rank, and rank 0 writes the results.  This
module imports neither JAX nor the JAX package; the test modules compare
its results with the JAX package's.

A case is a dict with a `kind` (a function below) and its inputs: port
configs, state_dicts (converted from the JAX parameters), numpy arrays.
"""
from __future__ import annotations

import torch

from rrtmil_tpu_torch.models.pool import MaxPool
from rrtmil_tpu_torch.parallel import collectives
from rrtmil_tpu_torch.parallel.mesh import global_array, make_mesh
from rrtmil_tpu_torch.parallel.seqshard import (make_seqshard_forward,
                                                make_seqshard_train_step,
                                                make_seqshard_value_and_grad)
from rrtmil_tpu_torch.parallel.train import make_sharded_train_step
from rrtmil_tpu_torch.train import losses
from rrtmil_tpu_torch.train.optim import make_optimizer

X_SPEC, M_SPEC = ("dp", "sp", None), ("dp", "sp")


def _slab(case, mesh):
    return (global_array(case["x"], mesh, X_SPEC),
            global_array(case["mask"], mesh, M_SPEC))


def forward(case):
    mesh = make_mesh(dp=case["dp"], sp=case["sp"])
    model, fwd, n_pad = make_seqshard_forward(case["cfg"], mesh,
                                              case["length"])
    model.load_state_dict(case["params"])
    return {"logits": fwd(*_slab(case, mesh)).numpy(), "n_pad": n_pad}


def value_and_grad(case):
    mesh = make_mesh(dp=case["dp"], sp=case["sp"])
    model, vag, n_pad = make_seqshard_value_and_grad(
        case["cfg"], mesh, case["length"], losses.cross_entropy)
    model.load_state_dict(case["params"])
    labels = global_array(case["labels"], mesh, ("dp",))
    loss, grads = vag(*_slab(case, mesh), labels)
    return {"loss": float(loss), "n_pad": n_pad,
            "grads": {k: g.numpy().copy() for k, g in grads.items()}}


def train_step(case):
    """One `make_seqshard_train_step` step from the given weights: its loss
    and the first parameter's change."""
    mesh = make_mesh(dp=case["dp"], sp=case["sp"])
    model, opt, step, _ = make_seqshard_train_step(
        case["cfg"], mesh, case["length"],
        lambda p: make_optimizer("adam", p, 2e-4, 1e-5), losses.cross_entropy)
    model.load_state_dict(case["params"])
    labels = global_array(case["labels"], mesh, ("dp",))
    loss = step(*_slab(case, mesh), labels)
    name, p = next(iter(model.named_parameters()))
    return {"loss": float(loss), "param": name,
            "delta": (p.detach() - case["params"][name]).numpy()}


def max_pool(case):
    """sum(MaxPool(x)^2) and its gradient in x, the slabs' gradients
    gathered back into the whole bag."""
    mesh = make_mesh(dp=1, sp=case["sp"])
    x, mask = _slab(case, mesh)
    x.requires_grad_(True)
    out = MaxPool(mesh.sp_group)(x, mask=mask)
    loss = (out ** 2).sum()
    collectives.scaled_loss(loss, mesh.world).backward()
    grad = collectives.all_gather(x.grad, 1, mesh.sp_group)
    return {"loss": float(loss), "grad": grad.numpy()}


def steps(case):
    """`make_sharded_train_step` on a (dp, sp) mesh, each rank its bags'
    slab: each step's loss over the global batch, and the parameters
    after the steps."""
    from rrtmil_tpu_torch.models.rrt import RRTMIL
    mesh = make_mesh(dp=case["dp"], sp=case["sp"])
    model = RRTMIL(case["cfg"])
    model.load_state_dict(case["params"])
    opt = make_optimizer("adam", model.parameters(), case["lr"], 0.0)
    step = make_sharded_train_step(model, opt, losses.cross_entropy, mesh,
                                   case["length"])
    x, mask = _slab(case, mesh)
    labels = global_array(case["labels"], mesh, ("dp",))
    out = [float(step(x, mask, labels)) for _ in range(case["steps"])]
    return {"losses": out, "params": {k: p.detach().numpy().copy()
                                      for k, p in model.named_parameters()}}


def engine(case):
    """One SeqShardSurvivalEngine epoch and validate from the given weights,
    then, at `grad_params`, the loss and gradients of bag `grad_bag`
    through the engine's own slab and model, dropout off."""
    from rrtmil_tpu_torch.data.survival import ArraySurvivalDataset
    from rrtmil_tpu_torch.train.surv_engine import SeqShardSurvivalEngine
    mesh = make_mesh(dp=1, sp=case["sp"])
    eng = SeqShardSurvivalEngine(case["cfg"], case["ecfg"], mesh)
    eng.load_state_dict(case["params"])
    ds = ArraySurvivalDataset(*case["data"])
    tr_loss, tr_ci = eng.train_epoch(ds, case["train_idx"], 0)
    vl, vci = eng.validate(ds, case["val_idx"])
    out = {"train": (tr_loss, tr_ci), "val": (vl, vci)}
    eng.load_state_dict(case["grad_params"])
    idx = case["grad_bag"]
    x, mask, spec, _, cens, label = eng._prep_indexed(ds, idx)
    eng.model.train()
    h, s = eng.model(x, mask=mask, length=spec.repr_length)
    loss = eng._loss(h, s, torch.tensor([label]),
                     torch.tensor([float(cens)]))
    collectives.scaled_loss(loss, mesh.world).backward()
    collectives.all_reduce_grads(eng.model.parameters())
    out["grad_loss"] = float(loss.detach())
    out["grads"] = {n: p.grad.numpy().copy()
                    for n, p in eng.model.named_parameters()}
    return out


def survival_cv(case):
    """run_survival_cv with --sp_shards on this rank: the meter's row of
    c-indices (header, 5 folds, mean, std)."""
    from rrtmil_tpu_torch.harness.survival import run_survival_cv
    return {"cindex": run_survival_cv(case["args"]).cindex}


KINDS = {"forward": forward, "value_and_grad": value_and_grad,
         "train_step": train_step,
         "max_pool": max_pool, "steps": steps, "engine": engine,
         "survival_cv": survival_cv}


def run(rank: int, in_path: str, out_path: str) -> None:
    torch.manual_seed(0)
    cases = torch.load(in_path, weights_only=False)
    results = {name: KINDS[case["kind"]](case)
               for name, case in cases.items()}
    if rank == 0:
        torch.save(results, out_path)


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))


# -- on the card (tests/test_torch_gpu.py) -----------------------------------

def _counters():
    from rrtmil_tpu_torch.ops.kernels import crmsa_kernels as ck
    from rrtmil_tpu_torch.ops.kernels import region_attn as ra
    from rrtmil_tpu_torch.ops.kernels import region_attn_bwd as rab
    from rrtmil_tpu_torch.ops.kernels import region_block as rb
    from rrtmil_tpu_torch.ops.kernels import region_layer as rl
    fns = (rl.region_layer_fused, rl.region_layer_bwd, ck.crmsa_compress_grid,
           ck.crmsa_compress_grid_bwd, rb.region_block_fused,
           ra.region_attention_fused, rab.region_attention_bwd,
           ck.crmsa_redistribute_grid_ln, ck.crmsa_redistribute_grid_ln_bwd,
           ck.crmsa_redistribute_grid, ck.crmsa_redistribute_grid_bwd,
           ck.crmsa_compress, ck.crmsa_redistribute)
    return {f"K{i + 1}": f for i, f in enumerate(fns)}


def _launches(reset=False):
    counters = _counters()
    if reset:
        for f in counters.values():
            f.launches = 0
    return {k: f.launches for k, f in counters.items()}


def _surv_value_and_grad(model, x, mask, length, world):
    from rrtmil_tpu_torch.train.losses import nll_surv_loss
    model.train()
    model.zero_grad(set_to_none=True)
    h, s = model(x, mask=mask, length=length)
    loss = nll_surv_loss(h, s, torch.tensor([1], device=x.device),
                         torch.tensor([0.0], device=x.device), alpha=0.0)
    collectives.scaled_loss(loss, world).backward()
    if world > 1:
        collectives.all_reduce_grads(model.parameters())
    return float(loss.detach()), {n: p.grad.detach().cpu().clone()
                                  for n, p in model.named_parameters()}


def card_seqshard(rank: int, out_path: str, length: int) -> None:
    """survival_default (dropout off, f32 products) on a bag of `length`
    patches over 2 ranks of the card: the sharded forward hazards, loss and
    gradients and the kernels they launched, and, on rank 0, the unsharded
    model's on the same card and weights; then two dp = 2 steps of c16_r50
    (one bag a rank) and, on rank 0, one process at B = 2."""
    import dataclasses
    from rrtmil_tpu_torch.config import c16_r50, survival_default
    from rrtmil_tpu_torch.data.bucketing import bucket_for
    from rrtmil_tpu_torch.models.rrt import RRTMIL, build_model, init_parameters
    from rrtmil_tpu_torch.models.survival import SurvivalHead
    from rrtmil_tpu_torch.parallel.mesh import local_mesh
    from rrtmil_tpu_torch.parallel.seqshard import (sharded_bucket_for,
                                                    sharded_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=1, sp=2)
    dev = mesh.device
    base = survival_default()
    cfg = dataclasses.replace(base, dropout=0.0, encoder=dataclasses.replace(
        base.encoder, dropout=0.0, mm_dtype="float32"))

    def surv(c, sg=None):
        m = SurvivalHead(RRTMIL(c, sg))
        init_parameters(m, torch.Generator().manual_seed(0))
        return m.to(dev)

    repr_len, n_pad = sharded_bucket_for(length, cfg.encoder, 2)
    g = torch.Generator(device=dev).manual_seed(length)
    x = torch.zeros(1, n_pad, cfg.input_dim, device=dev)
    x[0, :length] = torch.randn(length, cfg.input_dim, generator=g,
                                device=dev)
    mask = (torch.arange(n_pad, device=dev) < length)[None]
    n = n_pad // 2
    xs = x[:, rank * n:(rank + 1) * n].contiguous()
    ms = mask[:, rank * n:(rank + 1) * n]
    sharded = surv(sharded_config(cfg, 2), mesh.sp_group)
    _launches(reset=True)
    with torch.no_grad():
        hz = sharded.eval()(xs, mask=ms, length=repr_len)[0].cpu()
    loss, grads = _surv_value_and_grad(sharded, xs, ms, repr_len, 2)
    out = {"launches": _launches(), "hazards": hz, "loss": loss,
           "grads": grads}
    if rank == 0:
        ref = surv(cfg)
        with torch.no_grad():
            out["ref_hazards"] = ref.eval()(x, mask=mask,
                                            length=repr_len)[0].cpu()
        out["ref_loss"], out["ref_grads"] = _surv_value_and_grad(
            ref, x, mask, repr_len, 1)
    torch.distributed.barrier()

    dmesh = make_mesh(dp=2, sp=1)
    c16 = c16_r50()
    c16 = dataclasses.replace(c16, dropout=0.0, encoder=dataclasses.replace(
        c16.encoder, dropout=0.0, mm_dtype="float32"))
    spec = bucket_for(2213, c16.encoder)
    xb = torch.zeros(2, spec.data_length, 1024, device=dev)
    xb[:, :2213] = torch.randn(2, 2213, 1024, generator=g, device=dev)
    mb = (torch.arange(spec.data_length, device=dev) < 2213)[None].expand(
        2, -1).contiguous()
    yb = torch.tensor([0, 1], device=dev)

    def steps(mesh_, xx, mm, yy):
        model = build_model(c16, device=dev, seed=0)
        opt = make_optimizer("adam", model.parameters(), 2e-4, 1e-5)
        step = make_sharded_train_step(model, opt, losses.cross_entropy,
                                       mesh_, spec.repr_length)
        return [float(step(xx, mm, yy)) for _ in range(2)], \
            {k: p.detach().cpu() for k, p in model.named_parameters()}

    _launches(reset=True)
    out["dp"] = steps(dmesh, *(global_array(t, dmesh, ("dp",))
                               for t in (xb, mb, yb)))
    out["dp_launches"] = _launches()
    if rank == 0:
        out["dp_ref"] = steps(local_mesh(dev), xb, mb, yb)
    torch.distributed.barrier()
    recs = [None, None]
    torch.distributed.all_gather_object(recs, out)
    if rank == 0:
        torch.save(recs, out_path)
