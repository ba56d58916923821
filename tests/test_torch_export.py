"""The exported pipeline artifact (pvnet_tpu_torch/export.py): export ->
save -> load -> call against the direct pipeline.estimate_poses with the
same draws (bit for bit on the CPU), its graph's pvnet_torch operators,
determinism by seed; the closed-form LM Jacobian of ops/pnp.py against the
forward-mode autodiff form it replaces, PnP against JAX's; and the import
of export and serve without JAX.

JAX's test_export_artifact_is_custom_call_free has no counterpart: the
port's artifact holds its K1-K3 operators by design (the loading process
imports pvnet_tpu_torch.ops), and test_artifact_operators lists them."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.ops import pnp as JP
from pvnet_tpu_torch import export as TE
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.infer import load_model
from pvnet_tpu_torch.ops import pnp as TP
from pvnet_tpu_torch.ops.geometry import rodrigues, rotation_angle_deg
from tools.make_torch_fixture import DEFAULT_OUT

from test_torch_pipeline import _run_blocked

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
PARAMS = TPL.VoteParams(hyp_num=64, max_num=64, uncertainty_hyp_num=64)
SEED = 7
# artifact name -> build_exported options
CASES = {"plain": dict(fused_tail=False),
         "fused_uncertainty": dict(fused_tail=True, tail_depth=3,
                                   uncertainty=True)}
OPERATORS = {"plain": ["count_inliers", "pnp_epnp", "pnp_lm",
                       "select_cmajor"],
             "fused_uncertainty": ["count_inliers", "pnp_epnp", "pnp_lm",
                                   "select_nhwc"]}


@pytest.fixture(scope="module")
def views():
    """Two normalized 64x96 crops of the fixture around the objects."""
    with np.load(DEFAULT_OUT) as z:
        u8 = z["images"][:, 224:288, 264:360].copy()
        pts = z["points_3d"]
    return TPL.normalize_images(torch.tensor(u8)), pts


@pytest.fixture(scope="module")
def artifacts(views, tmp_path_factory):
    """Each case exported (f32 FCN and tail), saved and loaded again; with
    the model and the manifest it was exported from."""
    images, pts = views
    model = load_model(CKPT, 9, "cpu")
    out = {}
    for name, kw in CASES.items():
        program, shapes = TE.build_exported(
            model, pts, TE.LINEMOD_K, 2, 64, 96, vote_params=PARAMS, **kw)
        d = str(tmp_path_factory.mktemp(name))
        TE.save_artifact(program, d, {
            "batch": 2, "height": 64, "width": 96, "vn": 9,
            "device": "cpu", "input_dtype": "float32", "draws": shapes})
        with open(os.path.join(d, TE.MANIFEST)) as f:
            assert json.load(f)["draws"] == shapes
        out[name] = (TE.load_artifact(d), kw)
    return model, out


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_call_equals_direct_pipeline(views, artifacts, name):
    images, pts = views
    model, arts = artifacts
    art, kw = arts[name]
    pose, kps = art.call(images, SEED)
    draws = dict(zip(art.manifest["draws"], art.draws(SEED)))
    est = TPL.estimate_poses(model, images, torch.tensor(pts),
                             torch.tensor(TE.LINEMOD_K), PARAMS,
                             tail_dtype=torch.float32, **draws, **kw)
    assert pose.shape == (2, 3, 4) and kps.shape == (2, 9, 2)
    assert torch.isfinite(pose).all()
    assert torch.equal(pose, est.pose) and torch.equal(kps, est.kps)


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_operators(artifacts, name):
    art = artifacts[1][name][0]
    assert TE.custom_ops(art.program) == OPERATORS[name]
    calls = {k: v for k, v in TE.graph_ops(art.program).items()
             if k.startswith("pvnet_torch.")}
    # one selection, one count; the plain path's covariance pass selects
    # again, the fused one reuses its sample; one EPnP and one LM
    pnp = {"pvnet_torch.pnp_epnp.default": 1, "pvnet_torch.pnp_lm.default": 1}
    want = {"plain": {"pvnet_torch.select_cmajor.default": 1,
                      "pvnet_torch.count_inliers.default": 1, **pnp},
            "fused_uncertainty": {"pvnet_torch.select_nhwc.default": 1,
                                  "pvnet_torch.count_inliers.default": 2,
                                  **pnp}}
    assert calls == want[name]


def test_artifact_same_seed_same_pose(views, artifacts):
    images, _ = views
    art = artifacts[1]["fused_uncertainty"][0]
    a = art.call(images, 3)
    b = art.call(images.clone(), 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(art.draws(3)[1], art.draws(4)[1])
    with pytest.raises(ValueError, match="images must be"):
        art.call(images[:1], 3)


def test_draw_shapes_follow_the_path():
    p = TPL.VoteParams()
    assert TE.draw_shapes(8, 480, 640, p, True, True) == {
        "noise": [8, 240, 320], "pair_u": [8, 512, 2],
        "cov_pair_u": [8, 1024, 2]}
    assert TE.draw_shapes(8, 480, 640, p, True, False) == {
        "noise": [8, 480, 640], "pair_u": [8, 512, 2],
        "cov_noise": [8, 480, 640], "cov_pair_u": [8, 1024, 2]}


def _jvp_jacobian(p, *args):
    """The forward-mode form lm_refine used before: one jvp per
    parameter direction."""
    f = lambda q: TP._residuals(q, *args)               # noqa: E731
    basis = torch.eye(6, dtype=p.dtype)[:, None, :].expand(6, *p.shape)
    cols = torch.func.vmap(
        lambda tan: torch.func.jvp(f, (p,), (tan,))[1])(basis)
    return cols.permute(1, 2, 0)


@pytest.mark.parametrize("scale", [2.5, 1e-3, 1e-7])
def test_lm_jacobian_equals_the_jvp_form(scale):
    rng = np.random.RandomState(int(-np.log10(scale)) + 3)
    N, n = 64, 9
    w = rng.randn(N, 3) * rng.uniform(0.2, 1.0, (N, 1)) * scale
    w[0] = 0.0
    t = np.c_[rng.uniform(-0.1, 0.1, (N, 2)), rng.uniform(0.3, 1.0, (N, 1))]
    p = torch.tensor(np.c_[w, t], dtype=torch.float32)
    X = torch.tensor(rng.uniform(-0.1, 0.1, (N, n, 3)), dtype=torch.float32)
    x2 = torch.tensor(rng.uniform(0, 640, (N, n, 2)), dtype=torch.float32)
    w3 = torch.tensor(rng.uniform(0, 1, (N, n, 3)), dtype=torch.float32)
    for K in (torch.tensor(TE.LINEMOD_K), torch.tensor(TE.LINEMOD_K)
              .expand(N, 3, 3)):
        r, J = TP._residuals_and_jacobian(p, X, x2, K, w3)
        assert torch.equal(r, TP._residuals(p, X, x2, K, w3))
        want = _jvp_jacobian(p, X, x2, K, w3)
        rel = (J - want).abs().amax((1, 2)) / want.abs().amax((1, 2))
        assert float(rel.max()) < 1e-5, float(rel.max())


def test_uncertainty_pnp_against_jax():
    # the weighted solver (LM with the closed-form Jacobian) against JAX's
    # on one pose seen with noisy, weighted keypoints
    rng = np.random.RandomState(5)
    b, n = 4, 9
    pts3d = rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)
    K = TE.LINEMOD_K.astype(np.float32)
    R = np.asarray(rodrigues(torch.tensor(rng.randn(b, 3) * 0.5,
                                          dtype=torch.float32)))
    t = np.c_[rng.uniform(-0.05, 0.05, (b, 2)), rng.uniform(0.4, 0.7, (b, 1))]
    cam = pts3d @ R.transpose(0, 2, 1) + t[:, None]
    uv = cam @ K.T
    kps = (uv[..., :2] / uv[..., 2:]).astype(np.float32)
    kps += rng.randn(b, n, 2).astype(np.float32) * 0.5
    w3 = np.stack([rng.uniform(0.5, 2, (b, n)), rng.uniform(-0.2, 0.2, (b, n)),
                   rng.uniform(0.5, 2, (b, n))], -1).astype(np.float32)
    got = TP.uncertainty_pnp_batch(torch.tensor(kps), torch.tensor(w3),
                                   torch.tensor(pts3d), torch.tensor(K))
    want = np.asarray(jax.jit(JP.uncertainty_pnp_batch)(
        jnp.asarray(kps), jnp.asarray(w3), jnp.asarray(pts3d),
        jnp.asarray(K)))
    ang = rotation_angle_deg(got[..., :3], torch.tensor(want[..., :3]))
    assert float(ang.max()) < 0.05, ang
    np.testing.assert_allclose(got[..., 3].numpy(), want[..., 3], atol=5e-4)


def test_export_and_serve_import_without_jax(tmp_path):
    proc = _run_blocked(
        "import pvnet_tpu_torch.export as E, pvnet_tpu_torch.serve as S\n"
        "import torch\n"
        "torch.ops.pvnet_torch.select_nhwc.default\n"   # registered
        "for m in ('jax', 'flax', 'msgpack', 'PIL', 'pvnet_tpu'):\n"
        "    assert sys.modules[m] is None, m\n"
        "print(E.parse_args(['--points_3d', 'x']).batch,"
        " S.decode_image.__name__)\n", tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["8", "decode_image"]


@pytest.mark.parametrize("case", range(5))
def test_operator_fake_shapes_on_cpu(case):
    # what export's tracer sees of each operator (register_fake) has the
    # real CPU implementation's shapes and dtypes
    from torch._subclasses.fake_tensor import FakeTensorMode
    from test_torch_cuda import _op_cases
    op, args = _op_cases("cpu")[case]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == \
        [(r.shape, r.dtype) for r in real]
