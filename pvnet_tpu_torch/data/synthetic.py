"""Synthetic LINEMOD-style split, generated as arrays (numpy only).

Port of pvnet_tpu/data/synthetic.py's generator. The reference's synthetic
data comes from an external Blender pipeline (ref lib/utils/render_utils.py);
the JAX package stands in for it with a procedural duck, distractor blobs
placed as occluders and clutter, and a numpy z-buffer renderer, and writes
the result as a LINEMOD tree (JPEG images, PNG masks, pose files). The
port draws the same random numbers in the same order from the same
``np.random.RandomState`` and renders with the same numpy code, but keeps
the result in memory: :func:`generate_synthetic_linemod` returns the
arrays (raw, never JPEG-encoded), the ground-truth poses, the object's
metadata and the split. The machine that runs the port on the GPU has no
PIL. The box and cylinder meshes and :func:`render_multiclass_view` are the
JAX module's fuse-style multi-class scenes (data/multiclass.py builds them).
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pvnet_tpu_torch.config import LINEMOD_K
from pvnet_tpu_torch.data.ply import PlyMesh
from pvnet_tpu_torch.ops.fps import farthest_point_sampling
from pvnet_tpu_torch.ops.rasterize import render_mesh_attributes


def sample_sphere_poses(num: int, rng: np.random.RandomState,
                        azi_range=(0, 360), ele_range=(-15, 40)):
    """Azimuth/elevation pose sampling like the reference's fibonacci-sphere
    sampler (ref render_utils.py:90-108). Returns [num, 3] euler-ish
    (azi, ele, theta) degrees."""
    azis = rng.uniform(*azi_range, num)
    eles = rng.uniform(*ele_range, num)
    thetas = rng.uniform(-30, 30, num)
    return np.stack([azis, eles, thetas], axis=-1)


def _euler_to_R(azi, ele, theta):
    a, e, t = np.deg2rad([azi, ele, theta])

    def rz(x):
        return np.array([[np.cos(x), -np.sin(x), 0],
                         [np.sin(x), np.cos(x), 0], [0, 0, 1]])

    def rx(x):
        return np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)],
                         [0, np.sin(x), np.cos(x)]])

    return rz(t) @ rx(e) @ rz(a)
def make_duck_mesh(n_theta: int = 16, n_phi: int = 24, scale: float = 0.05
                   ) -> PlyMesh:
    """A lumpy, asymmetric test object, ~0.1 m across.

    Shape and coloring must both be asymmetric: pose from keypoint voting
    is only learnable when views are visually distinguishable (a symmetric
    untextured blob makes the direction-field regression ill-posed).
    """
    verts = []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            # one-sided bump + an off-axis dent break every symmetry
            r = (1.0
                 + 0.35 * np.exp(-((ph - 1.0) ** 2 + (th - 1.2) ** 2) / 0.3)
                 - 0.25 * np.exp(-((ph - 4.0) ** 2 + (th - 2.0) ** 2) / 0.5))
            x = r * np.sin(th) * np.cos(ph)
            y = 0.8 * r * np.sin(th) * np.sin(ph)
            z = 1.2 * r * np.cos(th)
            verts.append([x * scale, y * scale, z * scale])
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    # position-keyed octant texture so every viewpoint looks distinct
    ext = verts.max(0) - verts.min(0)
    rel = (verts - verts.min(0)) / np.maximum(ext, 1e-9)
    colors = np.stack([
        60 + 180 * rel[:, 0],
        40 + 200 * rel[:, 1],
        50 + 170 * np.abs(np.sin(rel[:, 2] * 6.0)),
    ], axis=-1).astype(np.uint8)
    return PlyMesh(vertices=verts, faces=np.asarray(faces, np.int32),
                   colors=colors)


def make_distractor_mesh(rng: np.random.RandomState,
                         scale: float = 0.04) -> PlyMesh:
    """A random lumpy blob with its own color scheme — occluder / clutter
    object for occlusion-style training images (stand-in for the other
    LINEMOD objects the reference's fuse set composites,
    ref data_utils.py:304-334)."""
    n_theta, n_phi = 10, 14
    bump_ph = rng.uniform(0, 2 * np.pi)
    bump_th = rng.uniform(0.5, 2.5)
    bump_amp = rng.uniform(-0.3, 0.5)
    ax = rng.uniform(0.6, 1.4, 3)
    verts = []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            r = 1.0 + bump_amp * np.exp(
                -((ph - bump_ph) ** 2 + (th - bump_th) ** 2) / 0.4)
            verts.append([ax[0] * r * np.sin(th) * np.cos(ph) * scale,
                          ax[1] * r * np.sin(th) * np.sin(ph) * scale,
                          ax[2] * r * np.cos(th) * scale])
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    base = rng.randint(60, 220, 3)
    rel = (verts - verts.min(0)) / np.maximum(verts.max(0) - verts.min(0),
                                              1e-9)
    colors = np.clip(base[None, :] + 60 * (rel - 0.5), 0, 255).astype(
        np.uint8)
    return PlyMesh(vertices=verts, faces=np.asarray(faces, np.int32),
                   colors=colors)


def make_box_mesh(scale: float = 0.045, height_ratio: float = 1.8,
                  texture_asym: float = 0.15) -> PlyMesh:
    """A square-base cuboid — 90-degree rotation symmetric in SHAPE.

    The symmetric eval class for the ADD-S branch (the reference's
    eggbox/glue, ref lib/utils/config.py:70 + evaluation_utils.py:119-130):
    a pose estimator can confuse the four symmetry-equivalent orientations,
    making plain ADD fail while ADD-S (nearest-point) scores correctly.
    ``texture_asym`` adds a mild color gradient so keypoint training still
    converges (like the real eggbox's texture); set 0 for a perfectly
    ambiguous object."""
    s, hh = scale, scale * height_ratio
    corners = np.array([[sx, sy, sz] for sz in (-hh, hh)
                        for sy in (-s, s) for sx in (-s, s)], np.float32)
    # subdivide each face 4x4 so the rasterizer shades smoothly
    verts, faces = [], []
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    n = 4
    for q in quads:
        a, b, c, d = corners[list(q)]
        base = len(verts)
        for i in range(n + 1):
            for j in range(n + 1):
                u, v = i / n, j / n
                verts.append((1 - u) * ((1 - v) * a + v * b)
                             + u * ((1 - v) * d + v * c))
        for i in range(n):
            for j in range(n):
                p0 = base + i * (n + 1) + j
                p1, p2, p3 = p0 + 1, p0 + n + 1, p0 + n + 2
                faces.append([p0, p1, p2])
                faces.append([p1, p3, p2])
    verts = np.asarray(verts, np.float32)
    rel = (verts - verts.min(0)) / np.maximum(verts.max(0) - verts.min(0),
                                              1e-9)
    colors = np.stack([
        150 + 60 * texture_asym * (2 * rel[:, 0] - 1) * 4,
        90 + 80 * rel[:, 2],
        60 + 40 * np.sin(rel[:, 2] * 9.0),
    ], axis=-1)
    return PlyMesh(vertices=verts, faces=np.asarray(faces, np.int32),
                   colors=np.clip(colors, 0, 255).astype(np.uint8))


def make_cylinder_mesh(radius: float = 0.035, half_h: float = 0.07,
                       n_phi: int = 24, n_z: int = 8) -> PlyMesh:
    """A capped cylinder with a painted stripe breaking the rotational
    symmetry visually (shape is continuously symmetric about its axis) —
    the third class for fuse-style composites."""
    verts, faces = [], []
    for i in range(n_z + 1):
        z = -half_h + 2 * half_h * i / n_z
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append([radius * np.cos(ph), radius * np.sin(ph), z])
    for i in range(n_z):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    top, bot = len(verts), len(verts) + 1
    verts.append([0.0, 0.0, half_h])
    verts.append([0.0, 0.0, -half_h])
    for j in range(n_phi):
        a = n_z * n_phi + j
        b = n_z * n_phi + (j + 1) % n_phi
        faces.append([a, b, top])
        a2, b2 = j, (j + 1) % n_phi
        faces.append([b2, a2, bot])
    verts = np.asarray(verts, np.float32)
    ph = np.arctan2(verts[:, 1], verts[:, 0])
    stripe = np.exp(-((ph - 0.8) ** 2) / 0.25)
    rel_z = (verts[:, 2] + half_h) / (2 * half_h)
    colors = np.stack([
        60 + 160 * stripe,
        170 - 90 * rel_z,
        90 + 120 * rel_z * (1 - stripe),
    ], axis=-1)
    return PlyMesh(vertices=verts, faces=np.asarray(faces, np.int32),
                   colors=np.clip(colors, 0, 255).astype(np.uint8))


def _render_object(mesh: PlyMesh, pose: np.ndarray, K: np.ndarray,
                   h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(shaded color [h,w,3] float32, depth [h,w]; depth 0 = background)."""
    attrs = (mesh.colors.astype(np.float32) if mesh.colors is not None
             else np.full((mesh.vertices.shape[0], 3), 180.0, np.float32))
    color_img, depth = render_mesh_attributes(
        pose, K, mesh.vertices, mesh.faces, attrs, h, w)
    m = depth > 0
    if m.any():
        zmin, zmax = depth[m].min(), depth[m].max()
        shade = 1.0 - 0.5 * (depth - zmin) / max(zmax - zmin, 1e-6)
        color_img = np.clip(color_img * shade[..., None], 0, 255)
    return color_img, depth


def _composite(mesh: PlyMesh, pose: np.ndarray, K: np.ndarray, h: int,
               w: int, distractors=()) -> Tuple[np.ndarray, np.ndarray]:
    """(colour [h, w, 3] float32, owner [h, w]): the target and its
    distractors z-buffered by nearest depth; owner -1 is background, 0 the
    target, i + 1 distractor i."""
    color_img, depth = _render_object(mesh, pose, K, h, w)
    depth = np.where(depth > 0, depth, np.inf)
    owner = np.where(np.isfinite(depth), 0, -1)             # -1 = background
    for di, (dmesh, dpose) in enumerate(distractors):
        dcol, dd = _render_object(dmesh, dpose, K, h, w)
        dd = np.where(dd > 0, dd, np.inf)
        closer = dd < depth
        depth = np.where(closer, dd, depth)
        owner = np.where(closer, di + 1, owner)
        color_img = np.where(closer[..., None], dcol, color_img)
    return color_img, owner


def _background(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """The noisy background: the only draw a render makes."""
    return rng.randint(0, 80, (h, w, 3)).astype(np.uint8)


def _paint(mesh: PlyMesh, pose: np.ndarray, K: np.ndarray, h: int, w: int,
           distractors, background: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb, mask) of one view over ``background``, which it paints in
    place."""
    color_img, owner = _composite(mesh, pose, K, h, w, distractors)
    mask = (owner == 0).astype(np.uint8)
    vis = owner >= 0
    background[vis] = color_img[vis].astype(np.uint8)
    return background, mask


def _paint_job(job) -> Tuple[np.ndarray, np.ndarray]:
    return _paint(*job)


def render_synthetic_view(mesh: PlyMesh, pose: np.ndarray, K: np.ndarray,
                          h: int, w: int,
                          rng: Optional[np.random.RandomState] = None,
                          distractors=()
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb uint8 [h, w, 3], mask uint8 [h, w]) via the numpy z-buffer.

    ``distractors`` is a sequence of (mesh, pose) clutter objects composited
    by nearest depth; the mask marks only the *visible* pixels of the
    target (ref data_utils.py:304-334, augmentation.py:187-202). The noisy
    background is the one draw from ``rng``; rendering draws nothing, so
    drawing it first leaves the stream as the JAX function leaves it."""
    rng = rng or np.random.RandomState(0)
    return _paint(mesh, pose, K, h, w, distractors, _background(rng, h, w))


def render_multiclass_view(meshes_poses, K: np.ndarray, h: int, w: int,
                           rng: Optional[np.random.RandomState] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse-style composite: render every (mesh, pose), z-buffer them, and
    label each pixel with its owning class.

    Args:
      meshes_poses: [(mesh, pose [3,4])] — class c = index + 1.
    Returns:
      (rgb uint8 [h, w, 3], label mask uint8 [h, w], 0 = background).
    The reference's analog composites pre-rendered LINEMOD crops into fuse
    images with per-class masks (ref lib/datasets/linemod_dataset.py fuse
    branch + data_utils.py:304-334)."""
    rng = rng or np.random.RandomState(0)
    depth = np.full((h, w), np.inf)
    owner = np.full((h, w), -1, np.int32)
    color = np.zeros((h, w, 3), np.float32)
    for ci, (mesh, pose) in enumerate(meshes_poses):
        col, dd = _render_object(mesh, pose, K, h, w)
        dd = np.where(dd > 0, dd, np.inf)
        closer = dd < depth
        depth = np.where(closer, dd, depth)
        owner = np.where(closer, ci, owner)
        color = np.where(closer[..., None], col, color)
    rgb = _background(rng, h, w)
    vis = owner >= 0
    rgb[vis] = color[vis].astype(np.uint8)
    return rgb, (owner + 1).astype(np.uint8)


def sample_object_pose(rng: np.random.RandomState,
                       z_range=(0.4, 0.8)) -> np.ndarray:
    azi, ele, theta = sample_sphere_poses(1, rng)[0]
    R = _euler_to_R(azi, ele, theta)
    t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                  rng.uniform(*z_range)])
    return np.concatenate([R, t[:, None]], 1).astype(np.float32)


def sample_distractors(pose: np.ndarray, rng: np.random.RandomState,
                       meshes, occluder_prob: float = 0.0,
                       max_clutter: int = 0):
    """(mesh, pose) clutter list for one image.

    With probability ``occluder_prob`` one distractor is placed *on the
    camera ray to the target*, 60-85% of its distance — guaranteed partial
    occlusion; up to ``max_clutter`` more are scattered nearby (fuse-style
    multi-object composites, ref data_utils.py:304-334)."""
    out = []
    t = pose[:, 3]
    if meshes and rng.rand() < occluder_prob:
        frac = rng.uniform(0.6, 0.85)
        jitter = np.array([rng.uniform(-0.02, 0.02),
                           rng.uniform(-0.02, 0.02), 0.0])
        dpose = sample_object_pose(rng)
        dpose[:, 3] = t * frac + jitter
        out.append((meshes[rng.randint(len(meshes))], dpose))
    for _ in range(rng.randint(0, max_clutter + 1) if max_clutter else 0):
        dpose = sample_object_pose(rng)
        dpose[:, 3] = t + np.array([rng.uniform(-0.15, 0.15),
                                    rng.uniform(-0.12, 0.12),
                                    rng.uniform(-0.1, 0.25)])
        out.append((meshes[rng.randint(len(meshes))], dpose))
    return out


def split_indices(num_images: int) -> Dict[str, np.ndarray]:
    """Image indices of the train / val / test lists, with the JAX
    generator's arithmetic: the first half trains, the next tenth is val,
    and test is everything after train (val included)."""
    n_train = max(1, int(num_images * 0.5))
    n_val = max(1, int(num_images * 0.1))
    idx = np.arange(num_images)
    return {"train": idx[:n_train], "val": idx[n_train:n_train + n_val],
            "test": idx[n_train:]}


def evaluation_order(num_images: int) -> np.ndarray:
    """The images ``tools/train.py --test_model`` evaluates, in its order:
    the test list without the val images (LineModImageDB's
    ``test_real_set``), then the val images (``val_real_set``)."""
    split = split_indices(num_images)
    val = set(split["val"].tolist())
    test_only = [i for i in split["test"].tolist() if i not in val]
    return np.asarray(test_only + split["val"].tolist(), np.int64)


def object_metadata(mesh: PlyMesh) -> Dict[str, np.ndarray]:
    """What the JAX package's LineModModelDB reads back from the tree the
    JAX generator writes: ``model_pts`` (the mesh's vertices),
    ``points_3d`` (8 init-center FPS points + the bbox centre, the
    Farthest keypoints) and ``diameter`` in metres (the mesh extent, stored
    in cm in distance.txt and divided by 100)."""
    v = np.asarray(mesh.vertices, np.float32)
    center = (v.max(0) + v.min(0)) / 2.0
    points_3d = np.concatenate(
        [farthest_point_sampling(v, 8, init_center=True), center[None]],
        0).astype(np.float32)
    ext = np.linalg.norm(v.max(0) - v.min(0))
    diameter = float(ext * 100.0) / 100.0
    return {"model_pts": v, "points_3d": points_3d,
            "diameter": np.float64(diameter)}


def generate_synthetic_linemod(num_images: int = 20,
                               image_hw: Tuple[int, int] = (480, 640),
                               seed: int = 0, occluder_prob: float = 0.0,
                               max_clutter: int = 0,
                               n_distractor_meshes: int = 8,
                               render: Optional[Iterable[int]] = None,
                               workers: int = 1) -> Dict[str, np.ndarray]:
    """The synthetic split of the JAX package's generate_synthetic_linemod,
    as arrays.

    One ``np.random.RandomState(seed)`` is drawn in the JAX order: the
    ``n_distractor_meshes`` distractor meshes first (only when
    occluder_prob > 0 or max_clutter > 0), then per image its pose, its
    distractors and its background. Only the images in ``render`` (by
    default all) are rasterized, in ``workers`` processes; the others
    still make their draws. Returns a dict of arrays:

      images     [m, h, w, 3] uint8 the rendered views, in index order
      masks      [m, h, w]    uint8 visible-target masks
      poses      [m, 3, 4]    float32 GT poses [R | t]
      index      [m]          int64 image number of each view
      points_3d, model_pts, diameter   (:func:`object_metadata`)
      K          [3, 3]       float32 LINEMOD intrinsics
      train, val, test        image numbers of each list
                              (:func:`split_indices`)
    """
    if num_images < 1:
        raise ValueError(f"num_images must be positive, got {num_images}")
    wanted = (set(range(num_images)) if render is None
              else {int(i) for i in render})
    if any(not 0 <= i < num_images for i in wanted):
        raise ValueError(f"render indices must lie in [0, {num_images})")
    rng = np.random.RandomState(seed)
    dmeshes = [make_distractor_mesh(rng) for _ in range(n_distractor_meshes)] \
        if (occluder_prob > 0 or max_clutter > 0) else []
    mesh = make_duck_mesh()
    h, w = image_hw
    K = LINEMOD_K.copy()
    jobs: List[tuple] = []
    poses, index = [], []
    for k in range(num_images):
        pose = sample_object_pose(rng)
        distractors = sample_distractors(pose, rng, dmeshes, occluder_prob,
                                         max_clutter)
        background = _background(rng, h, w)
        if k in wanted:
            jobs.append((mesh, pose, K, h, w, distractors, background))
            poses.append(pose)
            index.append(k)
    if workers > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(jobs)),
                                 mp_context=ctx) as ex:
            views = list(ex.map(_paint_job, jobs,
                                chunksize=max(1, len(jobs) // (4 * workers))))
    else:
        views = [_paint_job(j) for j in jobs]
    out = {"images": np.stack([v[0] for v in views]).astype(np.uint8),
           "masks": np.stack([v[1] for v in views]).astype(np.uint8),
           "poses": np.stack(poses).astype(np.float32),
           "index": np.asarray(index, np.int64), "K": K}
    out.update(object_metadata(mesh))
    out.update(split_indices(num_images))
    return out
