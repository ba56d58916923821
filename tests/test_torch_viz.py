"""The port's visualization helpers (pvnet_tpu_torch/utils/viz.py,
utils/draw.py, utils/colormap.py) and PIL's bilevel conversion
(data/image_io.to_bilevel) against the JAX package's utils/viz.py, PIL and
matplotlib, on the CPU.

The colorize, grid, splat, projection and point-file helpers must equal
JAX's exactly (arrays, bytes, decoded PNG pixels), and so must the
literal viridis table and ``colorize_vertex_field``. The overlays that JAX
draws with matplotlib are rasterized by the port (ROADMAP D5): each is
held to the geometry of JAX's own figure (its lines, patches and scatter
offsets, read back from the returned Figure) on a 60x80 black image:
every pixel of a drawing colour lies within 1 px of a primitive of that
colour, and points sampled every 0.5 px along each primitive land on a
coloured pixel (a pixel whose square lies within 1e-3 px of the point:
curves are polylines within 1e-4 px of the curve). The ellipse axes equal
those JAX's eigh gives to 1e-4 relative."""
import os

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib import cm
from PIL import Image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from pvnet_tpu.utils import viz as JZ  # noqa: E402
from pvnet_tpu_torch.data import image_io  # noqa: E402
from pvnet_tpu_torch.train.recorder import Recorder  # noqa: E402
from pvnet_tpu_torch.utils import draw  # noqa: E402
from pvnet_tpu_torch.utils import viz as TZ  # noqa: E402
from pvnet_tpu_torch.utils.colormap import VIRIDIS, viridis  # noqa: E402

H, W = 60, 80


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# --- exact helpers -----------------------------------------------------------

def test_viridis_table_and_lookup_equal_matplotlib():
    want = cm.viridis(np.arange(256))[:, :3]
    np.testing.assert_array_equal(VIRIDIS, want)
    x = np.concatenate([np.random.RandomState(0).rand(5000),
                        [0.0, 1.0, -0.3, 1.7, np.nan, 255 / 256,
                         np.nextafter(1.0, 0.0)]])
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(viridis(x.astype(dt)),
                                      cm.viridis(x.astype(dt))[:, :3])


def test_colorize_vertex_field_equals_jax():
    rng = np.random.RandomState(1)
    ver = rng.uniform(-1.3, 1.3, (3, 12, 16, 6)).astype(np.float32)
    weights = (rng.rand(3, 12, 16, 1) < 0.6).astype(np.float32)
    got = TZ.colorize_vertex_field(ver, weights)
    want = JZ.colorize_vertex_field(ver, weights)
    assert got.shape == (6, 12, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_exact_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    img = rng.randn(H, W, 3).astype(np.float32) * 1.5
    np.testing.assert_array_equal(TZ.imagenet_to_uint8(img),
                                  JZ.imagenet_to_uint8(img))
    labels = rng.randint(-2, 25, (2, H, W))
    np.testing.assert_array_equal(TZ.colorize_segmentation(labels),
                                  JZ.colorize_segmentation(labels))
    imgs = rng.randint(0, 256, (7, 9, 11, 3)).astype(np.uint8)
    for nrow in (1, 3, 5):
        np.testing.assert_array_equal(TZ.make_grid(imgs, nrow=nrow),
                                      JZ.make_grid(imgs, nrow=nrow))
    pts = rng.uniform(-10, 90, (200, 2))
    np.testing.assert_array_equal(TZ.img_pts_to_pts_img(pts, H, W),
                                  JZ.img_pts_to_pts_img(pts, H, W))
    p3 = rng.uniform(-0.1, 0.1, (50, 3)) + [0, 0, 0.6]
    R = np.linalg.qr(rng.randn(3, 3))[0]
    T = rng.randn(3) * 0.01
    K = np.array([[572.4, 0, 40.0], [0, 573.6, 30.0], [0, 0, 1]])
    for g, w in zip(TZ.pts_to_img_pts(p3, R, T, K),
                    JZ.pts_to_img_pts(p3, R, T, K)):
        np.testing.assert_array_equal(g, w)
    base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    cols = rng.randint(0, 256, (200, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        TZ.img_pts_to_pts_img_colors(base, pts, cols),
        JZ.img_pts_to_pts_img_colors(base, pts, cols))
    for a, b in zip(TZ.visualize_points_3d(p3, p3 + 0.003, K, H, W),
                    JZ.visualize_points_3d(p3, p3 + 0.003, K, H, W)):
        np.testing.assert_array_equal(a, b)

    xyz = rng.randn(5, 3)
    xyzrgb = np.concatenate([xyz, rng.randint(0, 256, (5, 3))], 1)
    for name, args in (("xyz", (xyz,)), ("xyzrgb", (xyzrgb,)),
                       ("colors", (xyz, cols[:5])),
                       ("one_color", (xyz, np.array([7, 8, 9])))):
        TZ.write_points(str(tmp_path / f"t_{name}.txt"), *args)
        JZ.write_points(str(tmp_path / f"j_{name}.txt"), *args)
        assert ((tmp_path / f"t_{name}.txt").read_bytes()
                == (tmp_path / f"j_{name}.txt").read_bytes()), name


def test_overlap_mask_array_and_pngs_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    mask = rng.randint(0, 3, (2, H, W))
    got = TZ.visualize_overlap_mask(img, mask,
                                    str(tmp_path / "t_{}.png"))
    want = JZ.visualize_overlap_mask(img, mask, str(tmp_path / "j_{}.png"))
    np.testing.assert_array_equal(got, want)
    for bi in range(2):
        ours = image_io.read_rgb(str(tmp_path / f"t_{bi}.png")).numpy()
        pil = image_io.read_rgb(str(tmp_path / f"j_{bi}.png")).numpy()
        np.testing.assert_array_equal(ours, pil)
        np.testing.assert_array_equal(ours, want[bi])


def test_recorder_grids_equal_jax():
    class Writer:
        def __init__(self):
            self.images = {}

        def add_image(self, name, img, step):
            self.images[name] = (img, step)

    rng = np.random.RandomState(4)
    seg = rng.randn(3, 2, 12, 16).astype(np.float32)           # NCHW
    ver = rng.uniform(-1, 1, (3, 6, 12, 16)).astype(np.float32)
    wts = (rng.rand(3, 1, 12, 16) < 0.5).astype(np.float32)
    rec = Recorder()
    rec.rec_segmentation(torch.from_numpy(seg), 1)   # no writer: nothing
    rec.writer = Writer()
    rec.rec_segmentation(torch.from_numpy(seg), 5)
    rec.rec_vertex(torch.from_numpy(ver), torch.from_numpy(wts), 6)
    segs = JZ.colorize_segmentation(np.argmax(seg.transpose(0, 2, 3, 1), -1))
    want_seg = JZ.make_grid(segs, nrow=3).transpose(2, 0, 1)
    verts = JZ.colorize_vertex_field(ver.transpose(0, 2, 3, 1),
                                     wts.transpose(0, 2, 3, 1))
    want_ver = JZ.make_grid(verts, nrow=4).transpose(2, 0, 1)
    got_seg, step = rec.writer.images["train/image/seg"]
    assert step == 5
    np.testing.assert_array_equal(got_seg, want_seg)
    np.testing.assert_array_equal(rec.writer.images["train/image/ver"][0],
                                  want_ver)


# --- PIL's bilevel conversion -----------------------------------------------

def _masks():
    m = np.zeros((H, W), np.uint8)
    m[10:45, 20:70] = 1
    ramp = np.random.RandomState(5).randint(0, 256, (H, W)).astype(np.uint8)
    return {"0_255": m * 255, "0_1": m, "ramp": ramp,
            "0_128": m * 128}


@pytest.mark.parametrize("name", ["0_255", "0_1", "ramp", "0_128"])
def test_to_bilevel_equals_pil_convert_1(tmp_path, name):
    g = _masks()[name]
    want = np.array(Image.fromarray(g).convert("1"))
    got = image_io.to_bilevel(g)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    if name == "0_255":
        assert got.sum() == (g > 0).sum()
    # through a PNG file, as tools/demo.py reads its mask
    Image.fromarray(g).save(str(tmp_path / "m.png"))
    np.testing.assert_array_equal(image_io.read_bilevel(
        str(tmp_path / "m.png")), want)


def test_read_bilevel_of_a_1bit_png_is_a_copy(tmp_path):
    g = _masks()["0_255"]
    Image.fromarray(g).convert("1").save(str(tmp_path / "b.png"))
    want = np.array(Image.open(str(tmp_path / "b.png")).convert("1"))
    np.testing.assert_array_equal(image_io.read_bilevel(
        str(tmp_path / "b.png")), want)


# --- drawn overlays against the geometry of JAX's figures --------------------

def _segment_samples(a, b, step=0.5):
    n = max(1, int(np.ceil(np.linalg.norm(b - a) / step)))
    t = np.linspace(0.0, 1.0, n + 1)[:, None]
    return a[None] + t * (b - a)[None]


def _dist_to_segments(p, segs):
    """Distance of points p [n, 2] to the nearest of segments [m, 2, 2]."""
    a, b = segs[:, 0][None], segs[:, 1][None]
    d = b - a
    t = np.clip(((p[:, None] - a) * d).sum(-1)
                / np.maximum((d * d).sum(-1), 1e-12), 0, 1)
    q = a + t[..., None] * d
    return np.linalg.norm(p[:, None] - q, axis=-1).min(1)


def _lands_on_colour(img, pts, colour=None, tol=1e-3):
    """Each point inside the image lies on a pixel (within tol px of its
    square) of ``colour`` (any non-black colour when None)."""
    hit = np.zeros(len(pts), bool)
    inside = ((pts[:, 0] >= -0.5) & (pts[:, 0] < W - 0.5)
              & (pts[:, 1] >= -0.5) & (pts[:, 1] < H - 0.5))
    for dx in (-tol, tol):
        for dy in (-tol, tol):
            xs = np.clip(np.floor(pts[:, 0] + dx + 0.5), 0, W - 1).astype(int)
            ys = np.clip(np.floor(pts[:, 1] + dy + 0.5), 0, H - 1).astype(int)
            px = img[ys, xs]
            ok = (px.any(-1) if colour is None
                  else (px == np.asarray(colour)).all(-1))
            hit |= ok
    return hit[inside].all(), inside.sum()


def _pixels_of(img, colour):
    ys, xs = np.nonzero((img == np.asarray(colour)).all(-1))
    return np.stack([xs, ys], -1).astype(np.float64)


def _check(img, segs_by_colour):
    """The two rules of the module docstring for segment primitives."""
    for colour, segs in segs_by_colour.items():
        segs = np.asarray(segs, np.float64).reshape(-1, 2, 2)
        px = _pixels_of(img, colour)
        assert len(px) > 0, colour
        assert _dist_to_segments(px, segs).max() <= 1.0, colour
        pts = np.concatenate([_segment_samples(a, b) for a, b in segs])
        ok, n = _lands_on_colour(img, pts)
        assert ok and n > 0, colour


def _lines(fig):
    """{rgb: [[p0, p1], ...]} of the 2-point lines of a JAX figure."""
    out = {}
    for ln in fig.axes[0].get_lines():
        xy = np.stack([ln.get_xdata(), ln.get_ydata()], -1)
        rgb = tuple(int(round(255 * c))
                    for c in matplotlib.colors.to_rgb(ln.get_color()))
        out.setdefault(rgb, []).append(xy)
    return out


def test_bounding_box_draws_jax_edges():
    rng = np.random.RandomState(6)
    pred = rng.uniform(-5, 85, (8, 2))
    gt = pred + rng.uniform(-4, 4, (8, 2))
    black = np.zeros((H, W, 3), np.uint8)
    assert TZ._BOX_EDGES == JZ._BOX_EDGES
    lines = _lines(JZ.visualize_bounding_box(black, pred, gt))
    assert sorted(lines) == sorted([draw.NAMED["g"], draw.NAMED["b"]])
    for colour, corners in ((draw.NAMED["b"], pred), (draw.NAMED["g"], gt)):
        want = np.stack([[corners[a], corners[b]] for a, b in JZ._BOX_EDGES])
        np.testing.assert_array_equal(np.stack(lines[colour]), want)
    got = TZ.visualize_bounding_box(black, pred, gt)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    # green is drawn over blue: the blue rule holds off the green pixels
    gonly = np.zeros_like(got)
    gonly[(got == draw.NAMED["g"]).all(-1)] = draw.NAMED["g"]
    _check(gonly, {draw.NAMED["g"]: lines[draw.NAMED["g"]]})
    bonly = TZ.visualize_bounding_box(black, pred)
    _check(bonly, {draw.NAMED["b"]: lines[draw.NAMED["b"]]})
    assert not black.any()                    # drawn into a copy


def test_ellipses_match_jax_patches(tmp_path):
    rng = np.random.RandomState(7)
    mean = rng.uniform(15, 60, (3, 2))
    cov = []
    for _ in range(3):
        A = rng.randn(2, 2) * 2
        cov.append(A @ A.T + 0.5 * np.eye(2))
    cov = np.stack(cov)
    gt = mean + 2.0
    black = np.zeros((H, W, 3), np.uint8)
    fig = JZ.visualize_voting_ellipse(black, mean, cov, gt)
    patches = fig.axes[0].patches
    assert len(patches) == 3
    for vi, e in enumerate(patches):
        width, height, ang = TZ.ellipse_params(cov[vi])
        np.testing.assert_allclose([width, height], [e.width, e.height],
                                   rtol=1e-4)
        # the same point set (an eigenvector's sign flips the angle by 180)
        ours = draw.ellipse_points(mean[vi], width, height, ang, 720)
        theirs = draw.ellipse_points(e.center, e.width, e.height, e.angle,
                                     720)
        np.testing.assert_allclose(
            np.sort(np.round(ours, 6), 0), np.sort(np.round(theirs, 6), 0),
            atol=1e-4)
    img = TZ.visualize_voting_ellipse(black, mean, cov, gt)
    blue = _pixels_of(img, draw.NAMED["b"])
    segs = np.concatenate([
        np.stack([p, np.roll(p, -1, 0)], 1)
        for p in (draw.ellipse_points(e.center, e.width, e.height, e.angle,
                                      4096) for e in patches)])
    segs = np.concatenate([segs, np.repeat(mean[:, None], 2, 1)])
    assert _dist_to_segments(blue, segs).max() <= 1.0
    for e in patches:
        pts = draw.ellipse_points(e.center, e.width, e.height, e.angle,
                                  int(np.pi * max(e.width, e.height) / 0.5)
                                  + 8)
        ok, n = _lands_on_colour(img, pts)
        assert ok and n > 0
    green = [m for p in gt for m in draw.marker_segments(p, "x", 3.0)]
    _check(img, {draw.NAMED["g"]: green})
    assert TZ.visualize_voting_ellipse(black, mean, cov, gt,
                                       save_path=str(tmp_path / "e.png")) \
        == str(tmp_path / "e.png")
    np.testing.assert_array_equal(
        image_io.read_rgb(str(tmp_path / "e.png")).numpy(), img)


def test_hypothesis_scatter_matches_jax():
    rng = np.random.RandomState(8)
    hyps = rng.uniform(-20, 100, (40, 3, 2))
    counts = rng.randint(0, 50, (40, 3))
    kps = rng.uniform(5, 55, (3, 2))
    black = np.zeros((H, W, 3), np.uint8)
    fig = JZ.visualize_hypothesis(black, hyps, counts, kps)
    fig.canvas.draw()
    sc, kx = fig.axes[0].collections
    offs = np.asarray(sc.get_offsets())
    face = np.round(sc.get_facecolors()[:, :3] * 255)
    img = TZ.visualize_hypothesis(black, hyps, counts, kps)
    pts = hyps.reshape(-1, 2)
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < W)
              & (pts[:, 1] >= 0) & (pts[:, 1] < H))
    np.testing.assert_array_equal(offs, pts[inside])
    cols = TZ.hypothesis_colors(counts.reshape(-1)[inside])
    assert np.abs(cols.astype(int) - face).max() <= 1
    np.testing.assert_array_equal(np.asarray(kx.get_offsets()), kps)
    red = [m for p in kps for m in draw.marker_segments(p, "x", 3.0)]
    # every coloured pixel: a hypothesis (its own colour, unless a later
    # one or a cross covers it) or a red cross
    xs, ys = np.floor(offs[:, 0] + 0.5), np.floor(offs[:, 1] + 0.5)
    dots = set(zip(xs.astype(int), ys.astype(int)))
    col = {}
    for x, y, c in zip(xs.astype(int), ys.astype(int), cols):
        col[(x, y)] = tuple(c)
    reds = _pixels_of(img, draw.NAMED["r"])
    near_red = _dist_to_segments(reds, np.asarray(red)) <= 1.0
    for (x, y) in zip(*np.nonzero(img.any(-1))[::-1]):
        if (x, y) in dots and tuple(img[y, x]) == col[(x, y)]:
            continue
        assert tuple(img[y, x]) == draw.NAMED["r"], (x, y)
    assert near_red.all()
    ok, _ = _lands_on_colour(img, offs)
    assert ok


def test_points_keypoints_and_multiclass_masks(tmp_path):
    rng = np.random.RandomState(9)
    rgb = np.zeros((2, H, W, 3), np.uint8)
    tgt = rng.uniform(5, 55, (2, 4, 2))
    pred = tgt + rng.uniform(-6, 6, (2, 4, 2))
    figs = JZ.visualize_points(rgb, tgt, pred)
    imgs = TZ.visualize_points(rgb, tgt, pred)
    for fig, img, t, p in zip(figs, imgs, tgt, pred):
        lines = fig.axes[0].get_lines()
        assert [ln.get_marker() for ln in lines] == ["*", "*"]
        np.testing.assert_array_equal(
            np.stack([lines[0].get_xdata(), lines[0].get_ydata()], -1), t)
        blue = [m for q in p for m in draw.marker_segments(q, "*", 3.0)]
        _check(img, {draw.NAMED["b"]: blue})
        green = _pixels_of(img, draw.NAMED["g"])
        gsegs = np.asarray([m for q in t
                            for m in draw.marker_segments(q, "*", 3.0)])
        assert _dist_to_segments(green, gsegs).max() <= 1.0

    figs = JZ.visualize_keypoints(rgb, tgt, pred)
    paths = TZ.visualize_keypoints(rgb, tgt, pred,
                                   save_path=str(tmp_path / "k_{}.png"))
    assert paths == [str(tmp_path / f"k_{i}.png") for i in range(2)]
    cols = TZ.keypoint_colors(4)
    for fig, path, t, p in zip(figs, paths, tgt, pred):
        c_o, c_x = fig.axes[0].collections
        np.testing.assert_array_equal(np.asarray(c_o.get_offsets()), t)
        np.testing.assert_array_equal(np.asarray(c_x.get_offsets()), p)
        img = image_io.read_rgb(path).numpy()
        for k in range(4):
            circle = draw.ellipse_points(t[k], 6.0, 6.0, 0.0, 256)
            ring = np.stack([circle, np.roll(circle, -1, 0)], 1)
            cross = draw.marker_segments(p[k], "x", 3.0)
            px = _pixels_of(img, cols[k])
            assert _dist_to_segments(
                px, np.concatenate([ring, cross])).max() <= 1.0

    pm = rng.randint(0, 4, (2, H, W))
    gm = rng.randint(0, 4, (2, H, W))
    for got, fig, a, b in zip(TZ.visualize_mask_multi_class(pm, gm),
                              JZ.visualize_mask_multi_class(pm, gm), pm, gm):
        ims = [ax.get_images()[0].get_array() for ax in fig.axes]
        assert got.shape == (H, 2 * W + 2, 3)
        np.testing.assert_array_equal(got[:, :W], np.asarray(ims[0]))
        np.testing.assert_array_equal(got[:, W + 2:], np.asarray(ims[1]))
        np.testing.assert_array_equal(got[:, :W],
                                      JZ.colorize_segmentation(a[None])[0])
    np.testing.assert_array_equal(
        TZ.visualize_mask(gm[0]), JZ.colorize_segmentation(gm[:1])[0])


def test_vanishing_point_arrows_match_jax():
    rng = np.random.RandomState(10)
    van = rng.randn(2, 4, 3)
    van[:, 3] = [[40.0, 30.0, 1.0], [35.0, 25.0, 1.0]]
    rgb = np.zeros((2, H, W, 3), np.uint8)
    figs = JZ.visualize_vanishing_points(rgb, van)
    imgs = TZ.visualize_vanishing_points(rgb, van)
    arrows = TZ.vanishing_arrows(van)
    for bi, (fig, img) in enumerate(zip(figs, imgs)):
        for di, (patch, colour) in enumerate(zip(fig.axes[0].patches,
                                                 "rgb")):
            start, d = arrows[bi, di]
            np.testing.assert_allclose(start, [patch._x, patch._y],
                                       rtol=1e-12)
            np.testing.assert_allclose(d, [patch._dx, patch._dy],
                                       rtol=1e-12, atol=1e-12)
        # arrows share their start: hold each colour's pixels to its own
        # arrow and the union of samples to the union of colours
        segs = {draw.NAMED[c]: draw.arrow_segments(*arrows[bi, di])
                for di, c in enumerate("rgb")}
        for colour, s in segs.items():
            px = _pixels_of(img, colour)
            assert _dist_to_segments(px, s).max() <= 1.0
        pts = np.concatenate([_segment_samples(a, b) for s in segs.values()
                              for a, b in s])
        ok, n = _lands_on_colour(img, pts)
        assert ok and n > 0


def test_segments_clip_and_survive_far_endpoints():
    img = np.zeros((H, W, 3), np.uint8)
    draw.draw_segment(img, (-1e7, 30.2), (1e7, 30.2), (1, 2, 3))
    assert (img[30] == (1, 2, 3)).all() and img.any(-1).sum() == W
    img[:] = 0
    draw.draw_segment(img, (np.nan, 1.0), (3.0, 4.0), (1, 2, 3))
    draw.draw_segment(img, (-50.0, -50.0), (-10.0, 200.0), (1, 2, 3))
    assert not img.any()
    draw.draw_segment(img, (10.3, 10.6), (10.3, 10.6), (9, 9, 9))
    assert img.any(-1).sum() == 1 and (img[11, 10] == 9).all()
    assert os.path.basename(draw.__file__) == "draw.py"
