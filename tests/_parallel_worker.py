"""The port's side of the data-parallel tests: one rank of a gloo group on
the CPU, started by :func:`spawn` (tests/test_torch_parallel.py) with
torchrun's environment. It never imports JAX.

  python tests/_parallel_worker.py mesh|model|spatial INPUT.pt OUTPUT.pt

``mesh``: the mesh helpers and the synchronized BatchNorm (any world
size); ``model``: one sharded train step, one sharded step from a
resident set with device augmentation, one sharded eval step and the
sharded pose pipeline, each from the weights and draws in INPUT;
``spatial`` (4 ranks, tests/test_torch_spatial.py): the row-sharded
fields and pose pipeline over sp=4 and on a 2x2 data x sp mesh. Rank 0
writes OUTPUT; every failed check raises, so the process exits non-zero.
"""
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(mode: str, world: int, inp: str, out: str,
          timeout: float = 120.0) -> None:
    """Run ``world`` ranks of this script on localhost (gloo, a fresh
    port, a 60 s process-group timeout) and wait at most ``timeout``
    seconds; raise with every rank's output if one fails or hangs."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), PVNET_PG_TIMEOUT="60",
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, inp, out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs, failed = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n(timed out)")
        failed |= p.returncode != 0
    if failed:
        raise AssertionError("\n".join(
            f"--- rank {r} (exit {p.returncode}):\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))


def run_mesh(inp, mesh):
    import numpy as np
    import torch
    import torch.distributed as dist
    from pvnet_tpu_torch.models.resnet import BatchNorm2d
    from pvnet_tpu_torch.parallel import (
        all_gather_rows, all_reduce_sum, convert_sync, make_global_mesh,
        make_mesh, replicate, replicate_global, shard_batch,
        shard_batch_global)
    n, r = mesh.size, mesh.rank
    out = {}

    # rows per rank: contiguous, a numpy leaf and a named tuple too
    x = torch.arange(4 * n * 3, dtype=torch.float32).reshape(4 * n, 3)
    got = shard_batch({"x": x, "i": np.arange(4 * n)}, mesh)
    assert torch.equal(got["x"], x[4 * r:4 * r + 4])
    assert got["i"].tolist() == list(range(4 * r, 4 * r + 4))
    try:
        shard_batch({"x": torch.zeros(4 * n + 1)}, mesh)
        raise AssertionError("an indivisible batch was split")
    except ValueError:
        pass
    out["rows"] = all_gather_rows(got["x"], mesh)

    # replicate: rank 0's values everywhere, tensors and modules
    t = replicate({"t": torch.full((5,), float(r) + 1)}, mesh)["t"]
    assert (t == 1).all(), t
    torch.manual_seed(r)
    lin = replicate(torch.nn.Linear(3, 2), mesh)
    torch.manual_seed(0)
    ref = torch.nn.Linear(3, 2)
    assert torch.equal(lin.weight, ref.weight)
    assert torch.equal(lin.bias, ref.bias)

    # the single-node guard, and the global helpers (tests/
    # test_multihost.py's 4 + 4 rows, a replicated weight, a global sum)
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        make_mesh("cpu")
        raise AssertionError("make_mesh() took a multi-node world")
    except NotImplementedError:
        pass
    assert make_mesh("cpu", group=dist.group.WORLD).size == n
    gmesh = make_global_mesh("cpu")
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    local = np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r
    batch = shard_batch_global({"x": local}, gmesh)
    w = replicate_global({"w": np.full((3,), 2.0, np.float32)}, gmesh)["w"]
    y = (batch["x"] * w).sum(1)
    out["global_rows"] = all_gather_rows(y, gmesh)
    out["global_sum"] = all_reduce_sum(y.sum(), gmesh)

    # the synchronized BatchNorm on this rank's rows of inp's batch
    def bn_of():
        bn = BatchNorm2d(inp["weight"].numel())
        with torch.no_grad():
            bn.weight.copy_(inp["weight"])
            bn.bias.copy_(inp["bias"])
        return convert_sync(bn, mesh)
    rows = mesh.rows(len(inp["x"]))
    bn = bn_of()
    xr = inp["x"][rows].clone().requires_grad_()
    yr = bn(xr)
    (yr * inp["g"][rows]).sum().backward()
    out["bn_y"] = all_gather_rows(yr.detach(), mesh)
    out["bn_dx"] = all_gather_rows(xr.grad, mesh)
    out["bn_dw"] = all_reduce_sum(bn.weight.grad.clone(), mesh)
    out["bn_db"] = all_reduce_sum(bn.bias.grad.clone(), mesh)
    out["bn_mean"], out["bn_var"] = bn.running_mean, bn.running_var
    # every rank holds the same statistics
    spread = all_gather_rows(torch.cat([bn.running_mean,
                                        bn.running_var])[None], mesh)
    assert (spread == spread[0]).all(), spread
    # under bf16 autocast the statistics are float32 ones of the bf16
    # values; eval mode communicates nothing (a lone rank's call returns)
    bn16, bn32 = bn_of(), bn_of()
    x16 = inp["x"][rows].bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y16 = bn16(x16)
    assert y16.dtype == torch.bfloat16
    bn32(x16.float())
    assert torch.equal(bn16.running_mean, bn32.running_mean)
    assert torch.equal(bn16.running_var, bn32.running_var)
    bn.eval()
    if r == 0:
        bn(inp["x"])
    return out


def run_model(inp, mesh):
    import torch
    from pvnet_tpu_torch import pipeline as TPL
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.augment_device import AugDraws
    from pvnet_tpu_torch.infer import load_model
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.ops import voting as TV
    from pvnet_tpu_torch.models.resnet import BatchNorm2d
    from pvnet_tpu_torch.parallel import (SyncBatchNorm2d, all_gather_rows,
                                          replicate)
    from pvnet_tpu_torch.train import trainer as TT
    torch.set_num_threads(1)
    cfg = TrainConfig()                 # the JAX side's optimizer
    aug_cfg = TrainConfig.from_json(inp["recipe"]).aug_cfg
    out = {}

    def state():        # the sharded step synchronizes its BatchNorm
        model = build_model("resnet18_8s", ver_dim=18)
        model.load_state_dict(inp["sd"])
        return TT.create_train_state(replicate(model, mesh), cfg)

    def grads(st):
        return {k: p.grad.clone() for k, p in st.model.named_parameters()}

    # (1) one sharded step on a global batch, from a model whose
    # BatchNorm layers were not synchronized beforehand
    st = state()
    bns = [m for m in st.model.modules() if isinstance(m, BatchNorm2d)]
    assert bns and not any(isinstance(m, SyncBatchNorm2d) for m in bns)
    out["step_metrics"] = TT.make_sharded_train_step(mesh)(st, inp["batch"])
    out["synchronized"] = [type(m).__name__ for m in bns]
    out["step_sd"] = st.model.state_dict()
    out["step_grads"] = grads(st)

    # (2) one sharded step from the resident set, augmented with the
    # global batch's draws (JAX's)
    st = state()
    step = TT.make_sharded_train_step_from_data(
        mesh, aug_cfg=aug_cfg, aug_hw=tuple(inp["aug_hw"]))
    out["data_metrics"] = step(st, inp["data"], inp["idx"],
                               draws=AugDraws(**inp["draws"]))
    out["data_sd"] = st.model.state_dict()
    out["data_grads"] = grads(st)
    if mesh.is_main:
        # the same step unsharded, on the whole batch in one process
        model = build_model("resnet18_8s", ver_dim=18)
        model.load_state_dict(inp["sd"])
        st = TT.create_train_state(model, cfg)
        out["one_metrics"] = TT.train_step_from_data(
            st, inp["data"], inp["idx"], draws=AugDraws(**inp["draws"]),
            aug_cfg=aug_cfg, aug_hw=tuple(inp["aug_hw"]))
        out["one_sd"] = st.model.state_dict()
        out["one_grads"] = grads(st)

    # (2') step (1) in float64, sharded and, on rank 0, unsharded: the
    # sharding's arithmetic without float32's rounding
    batch64 = {k: v.double() for k, v in inp["batch"].items()}
    st = state()
    st.model.double()
    st = TT.create_train_state(st.model, cfg)
    out["f64_metrics"] = TT.make_sharded_train_step(mesh)(st, batch64)
    out["f64_sd"], out["f64_grads"] = st.model.state_dict(), grads(st)
    if mesh.is_main:
        model = build_model("resnet18_8s", ver_dim=18)
        model.load_state_dict(inp["sd"])
        st = TT.create_train_state(model.double(), cfg)
        out["f64_one_metrics"] = TT.train_step(st, batch64)
        out["f64_one_sd"], out["f64_one_grads"] = (st.model.state_dict(),
                                                   grads(st))

    # (3) the sharded eval step on the initial weights
    out["eval_metrics"] = TT.make_sharded_eval_step(mesh)(state(),
                                                          inp["batch"])

    # (4) the sharded pose pipeline with the global draws; and this rank's
    # rows of the selection and counts from JAX's fields
    model = replicate(load_model(inp["ckpt"], 9, "cpu"), mesh)
    run = TPL.make_sharded_pose_pipeline(mesh, model, inp["points_3d"],
                                         inp["K"])
    draws = {"noise": inp["noise"], "pair_u": inp["pair_u"]}
    out["pose"], out["kps"] = run(inp["images"], draws=draws)
    rows = mesh.rows(len(inp["images"]))
    fg = TV.sample_foreground(inp["mask_j"][rows], inp["ver_j"][rows], 512,
                              noise=inp["noise"][rows])
    hyps = TV.generate_hypotheses(fg, 512, pair_u=inp["pair_u"][rows])
    out["fg"] = [all_gather_rows(t, mesh) for t in fg]
    out["hyps"] = all_gather_rows(hyps, mesh)
    out["counts"] = all_gather_rows(TV.count_inliers(fg, hyps, 0.99), mesh)
    return out


def run_spatial(inp, mesh):
    import torch
    from pvnet_tpu_torch.infer import load_model
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import fold_conv7_to_packed4
    from pvnet_tpu_torch.parallel import (all_gather_rows,
                                          make_spatial_field_fn,
                                          make_spatial_mesh,
                                          make_spatial_pose_pipeline)
    from pvnet_tpu_torch.parallel.spatial import gather_dim
    torch.set_num_threads(1)
    assert mesh.size == 4
    out = {}

    def model_of(**kw):
        model = build_model("resnet18_8s", ver_dim=18, **kw)
        sd = dict(inp["sd"])
        if kw.get("stem") == "packed4":
            k = "resnet18_8s.conv1.weight"
            sd[k] = fold_conv7_to_packed4(sd[k])
        model.load_state_dict(sd)
        return model.eval()

    def fields(smesh, model, images):
        """The whole batch's fields, gathered from every rank's slab."""
        mask, ver = make_spatial_field_fn(smesh, model)(images)
        assert mask.shape[1] * smesh.sp.size == images.shape[1]
        return (all_gather_rows(gather_dim(mask, smesh.sp, 1), smesh.data),
                all_gather_rows(gather_dim(ver, smesh.sp, 2), smesh.data))

    sp4 = make_spatial_mesh(sp=4)             # one data group of 4 shards
    mesh22 = make_spatial_mesh(sp=2)          # 2 data groups x 2 shards
    assert (sp4.data.size, sp4.sp.size, sp4.sp.rank) == (1, 4, mesh.rank)
    assert (mesh22.data.size, mesh22.sp.size) == (2, 2)
    assert (mesh22.data.rank, mesh22.sp.rank) == divmod(mesh.rank, 2)
    x64 = inp["images64"]
    out["field64"] = fields(sp4, model_of(), x64)
    out["packed64"] = fields(mesh22, model_of(stem="packed4"), x64)
    # dynamic int8 (every stage and the decoder), and the same model
    # unsharded on every rank
    q = model_of(quant_stages=(0, 1, 2, 3), quant_decoder=True)
    out["int8"] = fields(sp4, q, x64)
    with torch.no_grad():
        out["int8_one"] = q(x64.permute(0, 3, 1, 2).contiguous())
    try:
        make_spatial_field_fn(sp4, q)(torch.zeros(1, 72, 64, 3))
        raise AssertionError("72 rows were split over 4 shards")
    except ValueError as e:
        out["refusal"] = str(e)
    duck = load_model(inp["ckpt"], 9, "cpu")
    out["field128"] = fields(mesh22, duck, inp["crop"])
    for unc in (False, True):
        run = make_spatial_pose_pipeline(mesh22, duck, inp["points_3d"],
                                         inp["K"], uncertainty=unc)
        out[f"pipeline_{unc}"] = run(inp["crop"], draws=inp[f"draws_{unc}"])
    return out


def main():
    import torch
    from pvnet_tpu_torch.parallel import init_process_group
    mode, inp_path, out_path = sys.argv[1:4]
    mesh = init_process_group("cpu")
    assert mesh.group is not None and mesh.device.type == "cpu"
    inp = torch.load(inp_path, weights_only=False)
    out = {"mesh": run_mesh, "model": run_model,
           "spatial": run_spatial}[mode](inp, mesh)
    if mesh.is_main:
        torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
