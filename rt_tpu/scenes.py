"""Scene library: deterministic re-creations of the reference scenes.

Reference analog: scenes.rs — camera presets cam1/cam2/widecam/topdown
(scenes.rs:17-125) and scene factories (cover_scene, earth_scene,
gen_checkered, triangle_scene, generate_ground_plane, mesh_scene,
gltf_test).  Divergence by design: the reference builds scenes with
unseeded ``thread_rng`` (scenes.rs:147), so no two of its renders agree;
rt_tpu scenes take an explicit seed (SURVEY.md §4: deterministic goldens).

Asset textures: the reference embeds earth/mars/moon/saul images via
``include_bytes!`` (scenes.rs:150-153).  rt_tpu generates procedural
stand-ins by default (no binary assets in-repo) and accepts file paths.
"""

from __future__ import annotations

import numpy as np

from rt_tpu.camera import Camera, make_camera
from rt_tpu.config import RenderConfig
from rt_tpu.scene import SceneBuilder, SceneData
from rt_tpu.sky import SkyParams

WIDTH = 800  # window.rs:29
HEIGHT = 600  # window.rs:30
MAX_DEPTH = 100  # scenes.rs:15


def cam1(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:17-42: center (3,-5,0.6) looking at origin, z-up, vfov 20,
    focus at the lookat distance, no defocus."""
    center = np.array([3.0, -5.0, 0.6])
    lookat = np.zeros(3)
    return make_camera(
        center,
        lookat,
        (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.0,
        image_width=width,
        image_height=height,
        vertical_fov=20.0,
    )


def cam2(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:44-68: from (14,3,10), defocus 0.7deg, focus 16."""
    return make_camera(
        (14.0, 3.0, 10.0),
        (0.0, 0.0, 0.0),
        (0.0, 0.0, 1.0),
        focus_distance=16.0,
        defocus_angle=0.7,
        image_width=width,
        image_height=height,
        vertical_fov=20.0,
    )


def widecam(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:70-95: from (-14,-10,7) at (0,0,5), vfov 40."""
    center = np.array([-14.0, -10.0, 7.0])
    lookat = np.array([0.0, 0.0, 5.0])
    return make_camera(
        center,
        lookat,
        (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.0,
        image_width=width,
        image_height=height,
        vertical_fov=40.0,
    )


def topdown_cam(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:97-125: from (0.1,0.1,20) looking down, defocus 0.7deg."""
    center = np.array([0.1, 0.1, 20.0])
    lookat = np.zeros(3)
    return make_camera(
        center,
        lookat,
        (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.7,
        image_width=width,
        image_height=height,
        vertical_fov=20.0,
    )


def _procedural_texture(name: str, size: int = 64) -> np.ndarray:
    """Deterministic colorful stand-in for the reference's embedded planet
    textures (scenes.rs:150-158)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if name == "earth":
        r = 0.2 + 0.3 * np.sin(6.28 * 3 * x) * np.cos(6.28 * 2 * y)
        g = 0.4 + 0.3 * np.cos(6.28 * 2 * x + 1.0)
        b = 0.6 + 0.3 * np.sin(6.28 * y * 2 + 0.5)
    elif name == "mars":
        r = 0.7 + 0.2 * np.sin(6.28 * 4 * x * y)
        g = 0.3 + 0.1 * np.cos(6.28 * 2 * y)
        b = 0.15 + 0.05 * np.sin(6.28 * x)
    elif name == "moon":
        v = 0.5 + 0.3 * np.sin(6.28 * 5 * x) * np.sin(6.28 * 5 * y)
        r = g = b = v
    else:  # "saul" stand-in: warm portrait-ish gradient
        r = 0.8 - 0.3 * y
        g = 0.6 - 0.2 * y + 0.1 * np.sin(6.28 * x)
        b = 0.4 + 0.2 * x * y
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def add_ground_plane(
    b: SceneBuilder,
    width: float,
    length: float,
    z: float,
    material: int,
    top_is_up: bool = True,
) -> None:
    """Two triangles forming a ground quad (scenes.rs:310-342)."""
    hw, hl = width / 2.0, length / 2.0
    a = (-hw, -hl, z)
    bb = (hw, -hl, z)
    c = (hw, hl, z)
    d = (-hw, hl, z)
    if top_is_up:
        b.add_triangle(a, bb, c, material)
        b.add_triangle(a, c, d, material)
    else:  # reversed winding = opposite normal (hittable.rs:210-212)
        b.add_triangle(c, bb, a, material)
        b.add_triangle(d, c, a, material)


def cover_scene(
    grid_i: int = 11,
    grid_j: int = 11,
    camera: Camera | None = None,
    z: float = -0.2,
    seed: int = 0,
    with_ground: bool = True,
    texture_dir: str | None = None,
) -> SceneData:
    """The RTIOW cover scene (scenes.rs:146-238), deterministic.

    Big spheres: glass at p1, metal at p3, textured "saul" sphere facing the
    camera at the top-left position (the reference comments out the other
    three big spheres, scenes.rs:187-192).  Small spheres: a grid_i x grid_j
    lattice with random offsets, 5%/15%/80% glass/metal/lambertian mix and
    collision avoidance around the big-sphere sites.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    big_r = 0.7
    saul_loc = np.array([-1.0, 1.732, big_r + z])
    p1 = np.array([-1.0, -1.732, big_r + z])
    p2 = np.array([2.0, 0.0, big_r + z])
    p3 = np.array([-2.0, 0.0, big_r + z])
    p4 = np.array([1.0, 1.732, big_r + z])
    p5 = np.array([1.0, -1.732, big_r + z])

    glass = b.dielectric(1.5)
    metal = b.metal_solid((0.7, 0.6, 0.5), None)
    saul_tex = b.image_texture(_load_or_procedural("saul", texture_dir))
    saul_mat = b.lambertian(saul_tex)

    if with_ground:
        even = b.solid_color((0.1, 0.1, 0.1))
        odd = b.solid_color((0.95, 0.95, 0.95))
        checker = b.checker(3.0, even, odd)  # main.rs:31-34
        checker_mat = b.lambertian(checker)
        add_ground_plane(b, 10000.0, 10000.0, z, checker_mat, True)

    b.add_sphere(p1, big_r, glass)
    b.add_sphere(p3, big_r, metal)
    viewer = np.asarray(camera.center) if camera is not None else np.array([3.0, -5.0, 0.6])
    b.add_sphere(saul_loc, big_r, saul_mat, front_direction=viewer)

    big_sites = [p1, p2, p3, p4, saul_loc, p5]
    if grid_i * grid_j <= 2500:
        # Per-sphere loop (matches the reference's sequential generation,
        # scenes.rs:198-236, with a seeded generator).
        for i in range(-grid_i, grid_i):
            for j in range(-grid_j, grid_j):
                radius = 0.2
                albedo = rng.uniform(0.0, 1.0, 3)
                offset = np.array([rng.uniform(0.0, 0.9), rng.uniform(0.0, 0.9), z])
                center = np.array([float(i), float(j), radius]) + offset
                collide = radius + big_r + 1.0
                if any(np.linalg.norm(center - s) < collide for s in big_sites):
                    continue
                choose = rng.uniform(0.0, 1.0)
                if choose > 0.95:
                    mat = b.dielectric(1.5)
                elif choose > 0.8:
                    mat = b.metal_solid(albedo, rng.uniform(0.0, 0.5))
                else:
                    mat = b.lambertian_rgb(*albedo)
                b.add_sphere(center, radius, mat)
    else:
        # Vectorized generation for cover-large scale (the Python loop
        # costs ~2 minutes at 300x300); same distributions, different
        # draw order, so the same seed yields a different (equally valid)
        # arrangement than the loop path.
        ii, jj = np.meshgrid(
            np.arange(-grid_i, grid_i), np.arange(-grid_j, grid_j), indexing="ij"
        )
        n = ii.size
        radius = 0.2
        albedo = rng.uniform(0.0, 1.0, (n, 3))
        offsets = np.stack(
            [rng.uniform(0.0, 0.9, n), rng.uniform(0.0, 0.9, n), np.full(n, z)], -1
        )
        centers = (
            np.stack([ii.ravel(), jj.ravel(), np.full(n, radius)], -1) + offsets
        )
        collide = radius + big_r + 1.0
        keep = np.ones(n, bool)
        for site in big_sites:
            keep &= np.linalg.norm(centers - site, axis=-1) >= collide
        choose = rng.uniform(0.0, 1.0, n)
        fuzz = rng.uniform(0.0, 0.5, n)
        for k in np.nonzero(keep)[0]:
            if choose[k] > 0.95:
                mat = b.dielectric(1.5)
            elif choose[k] > 0.8:
                mat = b.metal_solid(albedo[k], fuzz[k])
            else:
                mat = b.lambertian_rgb(*albedo[k])
            b.add_sphere(centers[k], radius, mat)

    return b.build(sky=SkyParams.default())


def earth_scene(texture_dir: str | None = None) -> SceneData:
    """scenes.rs:127-138: one textured lambertian sphere."""
    b = SceneBuilder()
    tex = b.image_texture(_load_or_procedural("earth", texture_dir))
    mat = b.lambertian(tex)
    b.add_sphere((0.0, 0.0, 0.0), 2.0, mat)
    return b.build()


def gen_checkered() -> SceneData:
    """scenes.rs:240-260: two giant checkered spheres."""
    b = SceneBuilder()
    even = b.solid_color((0.2, 0.3, 0.1))
    odd = b.solid_color((0.9, 0.9, 0.9))
    checker = b.checker(0.31, even, odd)
    mat = b.lambertian(checker)
    b.add_sphere((0.0, -10.0, 0.0), 10.0, mat)
    b.add_sphere((0.0, 10.0, 0.0), 10.0, mat)
    return b.build()


def triangle_scene(texture_dir: str | None = None) -> SceneData:
    """scenes.rs:262-308: two checkered triangles, an earth ball, and a
    textured triangle."""
    b = SceneBuilder()
    c1e = b.solid_color((1.0, 0.0, 0.0))
    c1o = b.solid_color((0.0, 0.0, 1.0))
    mat1 = b.lambertian(b.checker(0.31, c1e, c1o))
    c2e = b.solid_color((0.2, 0.3, 0.1))
    c2o = b.solid_color((0.9, 0.9, 0.9))
    mat2 = b.lambertian(b.checker(0.31, c2e, c2o))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), mat1)
    b.add_triangle((1, 0, 0), (0, 0, 0), (0, 0, 1), mat2)
    earth_mat = b.lambertian(b.image_texture(_load_or_procedural("earth", texture_dir)))
    b.add_sphere((0.4, 0.4, 0.4), 0.3, earth_mat)
    saul_mat = b.lambertian(b.image_texture(_load_or_procedural("saul", texture_dir)))
    b.add_triangle((0, 0, 0), (0, 1, 0), (0, 0, 1), saul_mat)
    return b.build()


def _load_or_procedural(name: str, texture_dir: str | None) -> np.ndarray:
    if texture_dir is not None:
        import os

        from rt_tpu.io.png_io import load_image

        for ext in (".png", ".jpg", ".jpeg", ".webp"):
            path = os.path.join(texture_dir, name + ext)
            if os.path.exists(path):
                return load_image(path)
    return _procedural_texture(name)


def textured_spheres_scene(texture_dir: str | None = None) -> SceneData:
    """BASELINE config 2: spheres exercising every texture/material kind —
    checkered ground spheres, an image-textured globe, clear and frosted
    glass, fuzzy metal (frosted dielectric: material.rs:138-143)."""
    b = SceneBuilder()
    even = b.solid_color((0.2, 0.3, 0.1))
    odd = b.solid_color((0.9, 0.9, 0.9))
    checker_mat = b.lambertian(b.checker(0.31, even, odd))
    b.add_sphere((0.0, 0.0, -1000.0), 999.8, checker_mat)

    earth_mat = b.lambertian(b.image_texture(_load_or_procedural("earth", texture_dir)))
    b.add_sphere((0.0, 0.0, 0.5), 0.7, earth_mat, front_direction=(3.0, -5.0, 0.6))

    glass = b.dielectric(1.5)
    b.add_sphere((-1.6, 0.3, 0.4), 0.6, glass)
    frosted = b.dielectric(1.5, 0.15)
    b.add_sphere((1.6, 0.3, 0.4), 0.6, frosted)
    fuzzy_metal = b.metal_solid((0.8, 0.7, 0.5), 0.25)
    b.add_sphere((0.0, 1.8, 0.4), 0.6, fuzzy_metal)
    return b.build()


def scale_rotate_mat(
    roll_degrees: float,
    pitch_degrees: float,
    yaw_degrees: float,
    scalefactor: float,
) -> np.ndarray:
    """The reference's mesh placement matrix (scenes.rs:460-475).

    nalgebra semantics replicated exactly, including the quirk that the
    "roll" argument also rotates about Z (``from_euler_angles(0, 0, roll)``
    is a Z rotation): rotation = Ry(pitch) @ Rz(yaw) @ Rz(roll), and the
    whole homogeneous matrix is scaled by ``scalefactor``.  Consumers apply
    only the linear 3x3 part (Triangle::transform -> transform_vector,
    hittable.rs:214-227), so the uniform scale survives and the (zero)
    translation column is ignored.
    """

    def rz(deg):
        r = np.deg2rad(deg)
        c, s = np.cos(r), np.sin(r)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)

    def ry(deg):
        r = np.deg2rad(deg)
        c, s = np.cos(r), np.sin(r)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    rotation = ry(pitch_degrees) @ rz(yaw_degrees) @ rz(roll_degrees)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rotation
    return (m * scalefactor).astype(np.float32)


# The reference's five mesh slots: (obj filename stem, style, transform)
# in its exact order (scenes.rs:368-381).
MESH_SCENE_SLOTS = (
    ("bimba", "red_metal", (0.0, 90.0, 90.0, 12.0)),
    ("stanford-bunny", "plaster", (0.0, 90.0, 90.0, 12.0)),
    ("teapot", "metal", (0.0, -90.0, -90.0, 0.6)),
    ("Nefertiti", "frosted_glass", (90.0, 0.0, 0.0, 0.02)),
    ("armadillo", "metal", None),
)


def mesh_scene_reference(obj_dir: str, missing_ok: bool = True) -> SceneData:
    """Reference-parity ``mesh_scene`` (scenes.rs:344-393): the five classic
    meshes with their per-mesh materials and ``scale_rotate_mat`` placements
    (bimba/bunny upright at 12x, teapot at 0.6x, Nefertiti at 0.02x,
    armadillo untransformed) over the 0.75-scale checker ground.

    ``obj_dir`` holds ``<stem>.obj`` files; with ``missing_ok`` absent
    meshes are skipped (the reference would panic — TODO.md:69).
    """
    import os

    from rt_tpu.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    styles = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "frosted_glass": lambda: b.dielectric(1.5, 0.05),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.4),
        "red_metal": lambda: b.metal_solid((0.0, 0.5, 0.8), 0.3),
    }
    for stem, style, srm in MESH_SCENE_SLOTS:
        path = os.path.join(obj_dir, stem + ".obj")
        if not os.path.exists(path):
            if missing_ok:
                continue
            raise FileNotFoundError(path)
        mat = styles[style]()
        transform = scale_rotate_mat(*srm) if srm is not None else None
        for model in load_obj(path):
            b.add_triangles(model["vertices"], model["uvs"], mat, transform=transform)
    return b.build()


def mesh_scene(
    obj_paths: dict[str, str],
    seed: int = 0,
) -> SceneData:
    """OBJ showcase (reference analog: mesh_scene, scenes.rs:344-393 — five
    classic meshes with plaster/metal/frosted-glass materials).

    ``obj_paths`` maps a material style ('plaster' | 'glass' |
    'frosted_glass' | 'metal' | 'mirror' | 'red_metal') to an OBJ path;
    unknown styles get the dull-gray metal.  A checkered ground plane is
    included (scenes.rs:353-356).
    """
    from rt_tpu.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    styles = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "glass": lambda: b.dielectric(1.5),
        "frosted_glass": lambda: b.dielectric(1.5, 0.05),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.4),
        "mirror": lambda: b.metal_solid((0.95, 0.95, 0.95), None),
        "red_metal": lambda: b.metal_solid((0.0, 0.5, 0.8), 0.3),
    }
    for style, path in obj_paths.items():
        mat = styles.get(style, styles["metal"])()
        for model in load_obj(path):
            b.add_triangles(model["vertices"], model["uvs"], mat)
    return b.build()


def mesh_cam(width: int, height: int, dist: float = 5.5, height_z: float = 2.2) -> Camera:
    """Three-quarter view of a unit-scale mesh standing on the ground
    (the camera of the mesh benchmark configs 3-5)."""
    return make_camera(
        (dist, -dist, height_z),
        (0.0, 0.0, 1.0),
        (0.0, 0.0, 1.0),
        focus_distance=float((2 * dist * dist + (height_z - 1) ** 2) ** 0.5),
        defocus_angle=0.0,
        image_width=width,
        image_height=height,
        vertical_fov=32.0,
    )


def mesh_with_area_light(
    obj_path: str,
    light_radiance=(6.0, 6.0, 5.5),
    mesh_style: str = "plaster",
) -> SceneData:
    """Mesh lit by an emissive quad panel (BASELINE config 3 shape: "OBJ
    mesh via BVH traversal with emissive area light").  The emissive
    material is an rt_tpu extension — the reference's only light is its
    sky (SURVEY.md §2)."""
    from rt_tpu.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    mat = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.2),
        "glass": lambda: b.dielectric(1.5),
    }.get(mesh_style, lambda: b.lambertian_rgb(0.9, 0.9, 0.9))()
    for model in load_obj(obj_path):
        b.add_triangles(model["vertices"], model["uvs"], mat)

    light = b.emissive(light_radiance)
    # Overhead panel, normal facing down toward the scene.
    b.add_triangle((-1.5, -1.5, 4.0), (1.5, -1.5, 4.0), (0.0, 1.5, 4.0), light)
    b.add_triangle((0.0, 1.5, 4.0), (1.5, -1.5, 4.0), (-1.5, -1.5, 4.0), light)
    return b.build()


def bench_cover_config() -> tuple[SceneData, Camera, RenderConfig]:
    """BASELINE.json config 1: RTIOW cover scene, ~500 spheres,
    400x225 @ 10 spp."""
    camera = cam1(400, 225)
    scene = cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=10, max_depth=50)
    return scene, camera, cfg
