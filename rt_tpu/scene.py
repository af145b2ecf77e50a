"""Scene representation: device-resident SoA arrays + host-side builder.

The reference keeps an AoS ``Vec<Shape>`` of enum-dispatched Sphere/Triangle
structs, each holding an ``Arc<Material>`` pointer, with textures boxed
inside materials (hittable.rs:24-29, 101-105; material.rs:10-16;
texture.rs:12-18).  That pointer-chasing layout does not map onto batched device code.

rt_tpu inverts it into flat, statically-shaped SoA arrays:

- spheres and triangles in separate parallel arrays, addressed by a global
  primitive id (sphere ids first, then triangles);
- materials as a table of integer *type tags* + parameter columns (the
  enum_dispatch equivalent is a tag + masked select / lax.switch);
- textures as a table of tags + parameter columns, with all image textures
  packed into one shelf-packed f32 atlas (the reference decodes each texture
  into a 24+ B/px AoS Vec — the cause of its 40 GB Sponza blow-up,
  scenes.rs:443, TODO.md:69-70; the atlas is 12 B/px, deduplicated).

``SceneData`` is a pytree, so the whole scene is a valid ``jax.grad``
target: texture colors, atlas texels, fuzz, IOR and sky parameters all
receive gradients.

The "scene freeze" boundary mirrors the reference (``World::build``,
hittable.rs:33-46): ``SceneBuilder`` is mutable host-side Python; ``build()``
emits immutable device arrays (+ BVH, built on host).
"""

from __future__ import annotations

import hashlib

import numpy as np
import jax.numpy as jnp

from rt_tpu.pytree import PyTreeNode, static_field
from rt_tpu.sky import SkyParams

# Material type tags (reference enum Material, material.rs:12-16).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
# Extension beyond the reference (its only light is the sky; emissives are
# an acknowledged gap, reference TODO "maybe treating colors as
# probabilities will come back to bite me when i implement emissives",
# camera.rs:287): hits deposit throughput * emit and terminate.
MAT_EMISSIVE = 3

# Texture type tags (reference enum TextureEnum, texture.rs:14-18).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

class BvhArrays(PyTreeNode):
    """Flattened BVH in depth-first order with skip ("escape") indices for
    stackless traversal (built host-side; see rt_tpu/bvh/).

    Node layout: interior nodes store child AABBs implicitly via their own
    entries; traversal walks ``hit_next`` on AABB hit and ``miss_next`` on
    miss.  Leaves reference a contiguous range of ``prim_order``.
    """

    node_min: jnp.ndarray  # f32[NN,3]
    node_max: jnp.ndarray  # f32[NN,3]
    hit_next: jnp.ndarray  # i32[NN] next node index if AABB hit (DFS order)
    miss_next: jnp.ndarray  # i32[NN] next node index if AABB missed (escape)
    leaf_start: jnp.ndarray  # i32[NN] first index into prim_order (-1 interior)
    leaf_count: jnp.ndarray  # i32[NN]
    prim_order: jnp.ndarray  # i32[NP] permutation of global prim ids


class SceneData(PyTreeNode):
    """Immutable device-resident scene (reference analog: World,
    hittable.rs:24-29)."""

    # Spheres (SoA; reference: Sphere struct, hittable.rs:260-268).
    sph_center: jnp.ndarray  # f32[S,3]
    sph_radius: jnp.ndarray  # f32[S]
    sph_front_dir: jnp.ndarray  # f32[S,3] texture-facing direction
    sph_material: jnp.ndarray  # i32[S]

    # Triangles (SoA; reference: Triangle struct, hittable.rs:152-163).
    tri_a: jnp.ndarray  # f32[T,3]
    tri_b: jnp.ndarray  # f32[T,3]
    tri_c: jnp.ndarray  # f32[T,3]
    tri_normal: jnp.ndarray  # f32[T,3] flat normal, precomputed like
    # the reference (normalize(normalize(b-a) x normalize(c-a)), hittable.rs:169-178)
    tri_uv: jnp.ndarray  # f32[T,3,2] per-vertex UVs
    tri_material: jnp.ndarray  # i32[T]

    # Material table (reference: enum Material + per-variant fields).
    mat_kind: jnp.ndarray  # i32[M] MAT_*
    mat_texture: jnp.ndarray  # i32[M] texture id (lambertian/metal)
    mat_fuzz: jnp.ndarray  # f32[M] metal fuzz / dielectric frost (0 = none)
    mat_ior: jnp.ndarray  # f32[M] dielectric refractive index

    # Texture table (reference: enum TextureEnum + per-variant fields).
    tex_kind: jnp.ndarray  # i32[X] TEX_*
    tex_color: jnp.ndarray  # f32[X,3] solid color
    tex_inv_scale: jnp.ndarray  # f32[X] checker 1/scale (texture.rs:54)
    tex_children: jnp.ndarray  # i32[X,2] checker (even, odd) texture ids
    tex_rect: jnp.ndarray  # i32[X,4] image (x0, y0, w, h) in the atlas

    atlas: jnp.ndarray  # f32[AH,AW,3] packed image textures

    sky: SkyParams

    bvh: BvhArrays | None = None

    # Hot-path shading data (see rt_tpu/fast_shade.py): every
    # per-primitive shading parameter packed into one dense f32[F, P]
    # matrix, so the wavefront fetches a hit's whole parameter set in one
    # operation instead of ~20 separate gathers.  None when the scene
    # uses a texture configuration the packed table can't express
    # (checker with non-solid children) — the generic path still works.
    shade_table: jnp.ndarray | None = None  # f32[F, P_pad]

    # Static metadata.
    num_spheres: int = static_field(0)
    num_triangles: int = static_field(0)
    has_image_textures: bool = static_field(False)

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_triangles


class _Texture:
    def __init__(self, kind, color=(0, 0, 0), inv_scale=0.0, children=(-1, -1), image=None):
        self.kind = kind
        self.color = color
        self.inv_scale = inv_scale
        self.children = children
        self.image = image  # np.f32[h,w,3] for TEX_IMAGE


class _Material:
    def __init__(self, kind, texture=-1, fuzz=0.0, ior=1.0):
        self.kind = kind
        self.texture = texture
        self.fuzz = fuzz
        self.ior = ior


class SceneBuilder:
    """Host-side mutable scene assembly (reference analog: the
    ``Vec<Shape>`` push pattern in scenes.rs + ``World::build``)."""

    def __init__(self):
        self._textures: list[_Texture] = []
        self._materials: list[_Material] = []
        self._spheres: list[tuple] = []
        self._triangles: list[tuple] = []

    # -- textures ----------------------------------------------------------

    def solid_color(self, rgb) -> int:
        """SolidColor (texture.rs:21-41)."""
        self._textures.append(_Texture(TEX_SOLID, color=tuple(float(c) for c in rgb)))
        return len(self._textures) - 1

    def checker(self, scale: float, even_tex: int, odd_tex: int) -> int:
        """3-D checker on floor(point/scale) parity (texture.rs:44-74).

        Children must be leaf textures (solid/image); the reference's type
        allows arbitrary recursion but its scenes never use it, and one
        level keeps the device dispatch flat.
        """
        for child in (even_tex, odd_tex):
            if self._textures[child].kind == TEX_CHECKER:
                raise ValueError("nested checker textures are not supported")
        self._textures.append(
            _Texture(TEX_CHECKER, inv_scale=1.0 / scale, children=(even_tex, odd_tex))
        )
        return len(self._textures) - 1

    def image_texture(self, image: np.ndarray) -> int:
        """ImageTexture from an f32[h,w,3] array in [0,1] (texture.rs:76-97).
        Identical pixel buffers are deduplicated in the atlas at build()."""
        image = np.ascontiguousarray(np.asarray(image, np.float32))
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image texture must be (h, w, 3), got {image.shape}")
        self._textures.append(_Texture(TEX_IMAGE, image=image))
        return len(self._textures) - 1

    # -- materials ---------------------------------------------------------

    def lambertian(self, texture: int) -> int:
        """Lambertian (material.rs:62-76)."""
        self._materials.append(_Material(MAT_LAMBERTIAN, texture=texture))
        return len(self._materials) - 1

    def lambertian_rgb(self, r: float, g: float, b: float) -> int:
        return self.lambertian(self.solid_color((r, g, b)))

    def metal(self, texture: int, fuzz: float | None = None) -> int:
        """Metal with optional fuzz (material.rs:78-92).  fuzz=None and
        fuzz=0.0 are equivalent (zero perturbation)."""
        self._materials.append(_Material(MAT_METAL, texture=texture, fuzz=float(fuzz or 0.0)))
        return len(self._materials) - 1

    def metal_solid(self, rgb, fuzz: float | None = None) -> int:
        return self.metal(self.solid_color(rgb), fuzz)

    def dielectric(self, refractive_index: float, fuzz: float | None = None) -> int:
        """Dielectric; fuzz > 0 gives the frosted variant
        (material.rs:122-148)."""
        self._materials.append(
            _Material(MAT_DIELECTRIC, fuzz=float(fuzz or 0.0), ior=float(refractive_index))
        )
        return len(self._materials) - 1

    def emissive(self, rgb) -> int:
        """Emissive area-light material (extension; see MAT_EMISSIVE).
        ``rgb`` is HDR radiance — values above 1 are fine (the RR clamp
        keeps the integrator safe, unlike the reference's gen_bool panic)."""
        tex = self.solid_color(rgb)
        self._materials.append(_Material(MAT_EMISSIVE, texture=tex))
        return len(self._materials) - 1

    # -- primitives --------------------------------------------------------

    def add_sphere(self, center, radius: float, material: int, front_direction=(1.0, 0.0, 0.0)):
        """Sphere; ``front_direction`` orients the texture
        (hittable.rs:270-296; default +x)."""
        self._spheres.append(
            (
                tuple(float(c) for c in center),
                max(float(radius), 0.0),
                tuple(float(c) for c in front_direction),
                material,
            )
        )

    def add_triangle(self, a, b, c, material: int, uv_a=(0.0, 0.0), uv_b=(1.0, 0.0), uv_c=(0.5, 1.0)):
        """Triangle with per-vertex UVs; defaults match the reference
        (hittable.rs:166-208)."""
        self._triangles.append(
            (
                np.asarray(a, np.float32),
                np.asarray(b, np.float32),
                np.asarray(c, np.float32),
                np.asarray([uv_a, uv_b, uv_c], np.float32),
                material,
            )
        )

    def add_triangles(
        self,
        vertices: np.ndarray,
        uvs: np.ndarray | None,
        material: int,
        transform: np.ndarray | None = None,
        shift=None,
    ):
        """Bulk triangle append: vertices f32[n,3,3], uvs f32[n,3,2]|None.

        ``transform`` applies a 4x4 matrix's rotation/scale part (the
        reference's Triangle::transform uses nalgebra's transform_vector —
        no translation, hittable.rs:214-227); ``shift`` adds a translation
        (Triangle::shift, hittable.rs:229-239)."""
        vertices = np.asarray(vertices, np.float32)
        if transform is not None:
            t = np.asarray(transform, np.float32)
            flat = vertices.reshape(-1, 3) @ t[:3, :3].T
            vertices = flat.reshape(-1, 3, 3)
        if shift is not None:
            vertices = vertices + np.asarray(shift, np.float32)[None, None, :]
        if uvs is None:
            uvs = np.broadcast_to(
                np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32),
                (vertices.shape[0], 3, 2),
            )
        for v, uv in zip(vertices, np.asarray(uvs, np.float32)):
            self._triangles.append((v[0], v[1], v[2], uv, material))

    # -- freeze ------------------------------------------------------------

    def build(self, sky: SkyParams | None = None, use_bvh: bool | None = None) -> SceneData:
        """Freeze into device arrays (reference analog: World::build,
        hittable.rs:33-46; BVH construction included when beneficial)."""
        sky = sky if sky is not None else SkyParams.default()

        s = max(len(self._spheres), 1)
        sph_center = np.zeros((s, 3), np.float32)
        sph_radius = np.zeros((s,), np.float32)  # r=0 spheres can never be hit
        sph_front = np.tile(np.array([1.0, 0, 0], np.float32), (s, 1))
        sph_mat = np.zeros((s,), np.int32)
        for i, (c, r, f, m) in enumerate(self._spheres):
            sph_center[i], sph_radius[i], sph_front[i], sph_mat[i] = c, r, f, m

        t = max(len(self._triangles), 1)
        tri_a = np.zeros((t, 3), np.float32)
        tri_b = np.zeros((t, 3), np.float32)
        tri_c = np.zeros((t, 3), np.float32)
        tri_uv = np.zeros((t, 3, 2), np.float32)
        tri_mat = np.zeros((t,), np.int32)
        for i, (a, b, c, uv, m) in enumerate(self._triangles):
            tri_a[i], tri_b[i], tri_c[i], tri_uv[i], tri_mat[i] = a, b, c, uv, m
        # Flat normal precomputed exactly like the reference: the edges are
        # normalized *before* the cross product (hittable.rs:169-178).
        e1 = _normalize_rows(tri_b - tri_a)
        e2 = _normalize_rows(tri_c - tri_a)
        tri_normal = _normalize_rows(np.cross(e1, e2))

        m = max(len(self._materials), 1)
        mat_kind = np.zeros((m,), np.int32)
        mat_tex = np.zeros((m,), np.int32)
        mat_fuzz = np.zeros((m,), np.float32)
        mat_ior = np.ones((m,), np.float32)
        for i, mt in enumerate(self._materials):
            mat_kind[i], mat_tex[i], mat_fuzz[i], mat_ior[i] = (
                mt.kind,
                mt.texture,
                mt.fuzz,
                mt.ior,
            )

        x = max(len(self._textures), 1)
        tex_kind = np.zeros((x,), np.int32)
        tex_color = np.zeros((x, 3), np.float32)
        tex_inv_scale = np.zeros((x,), np.float32)
        tex_children = np.zeros((x, 2), np.int32)
        tex_rect = np.zeros((x, 4), np.int32)

        # Shelf-pack image textures into one atlas (12 B/px vs the
        # reference's 24+ B/px AoS clone per primitive, camera.rs:104-118).
        images = [(i, tx.image) for i, tx in enumerate(self._textures) if tx.kind == TEX_IMAGE]
        seen: dict[bytes, int] = {}
        unique: list[np.ndarray] = []
        rect_of: dict[int, int] = {}
        for tex_id, img in images:
            # Full-buffer hash: a prefix digest silently aliased distinct
            # textures sharing their first rows (e.g. a common sky band).
            digest = (
                hashlib.sha1(img.tobytes()).digest() + repr(img.shape).encode()
            )
            if digest not in seen:
                seen[digest] = len(unique)
                unique.append(img)
            rect_of[tex_id] = seen[digest]
        atlas_w = max([im.shape[1] for im in unique], default=1)
        atlas_h = max(sum(im.shape[0] for im in unique), 1)
        atlas = np.zeros((atlas_h, atlas_w, 3), np.float32)
        offsets = []
        y = 0
        for im in unique:
            atlas[y : y + im.shape[0], : im.shape[1]] = im
            offsets.append((0, y, im.shape[1], im.shape[0]))
            y += im.shape[0]

        for i, tx in enumerate(self._textures):
            tex_kind[i] = tx.kind
            tex_color[i] = tx.color
            tex_inv_scale[i] = tx.inv_scale
            tex_children[i] = tx.children
            if tx.kind == TEX_IMAGE:
                tex_rect[i] = offsets[rect_of[i]]

        from rt_tpu.fast_shade import build_shade_table

        shade_np = build_shade_table(
            sph_center, sph_radius, sph_front, sph_mat,
            tri_a, tri_b, tri_c, tri_normal, tri_uv, tri_mat,
            mat_kind, mat_tex, mat_fuzz, mat_ior,
            tex_kind, tex_color, tex_inv_scale, tex_children, tex_rect,
            len(self._spheres), len(self._triangles),
        )
        scene = SceneData(
            shade_table=jnp.asarray(shade_np) if shade_np is not None else None,
            has_image_textures=any(t.kind == TEX_IMAGE for t in self._textures),
            sph_center=jnp.asarray(sph_center),
            sph_radius=jnp.asarray(sph_radius),
            sph_front_dir=jnp.asarray(sph_front),
            sph_material=jnp.asarray(sph_mat),
            tri_a=jnp.asarray(tri_a),
            tri_b=jnp.asarray(tri_b),
            tri_c=jnp.asarray(tri_c),
            tri_normal=jnp.asarray(tri_normal),
            tri_uv=jnp.asarray(tri_uv),
            tri_material=jnp.asarray(tri_mat),
            mat_kind=jnp.asarray(mat_kind),
            mat_texture=jnp.asarray(mat_tex),
            mat_fuzz=jnp.asarray(mat_fuzz),
            mat_ior=jnp.asarray(mat_ior),
            tex_kind=jnp.asarray(tex_kind),
            tex_color=jnp.asarray(tex_color),
            tex_inv_scale=jnp.asarray(tex_inv_scale),
            tex_children=jnp.asarray(tex_children),
            tex_rect=jnp.asarray(tex_rect),
            atlas=jnp.asarray(atlas),
            sky=sky,
            bvh=None,
            num_spheres=len(self._spheres),
            num_triangles=len(self._triangles),
        )

        n_prims = scene.num_prims
        if use_bvh is None:
            # Brute force beats the per-ray walk for small scenes; the BVH
            # wins once the (rays x prims) product gets heavy — triangles
            # sooner (their brute path materializes [N,T,3] cross products).
            use_bvh = (len(self._triangles) > 256) or (n_prims > 4096)
        if use_bvh and n_prims > 0:
            from rt_tpu.bvh import build_bvh  # local import: optional native lib

            scene = scene.replace(bvh=build_bvh(self._prim_bounds()))
        return scene

    def _prim_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-primitive AABBs in global prim-id order (spheres then
        triangles), matching the reference's Bounded impls
        (hittable.rs:299-306, 242-248)."""
        mins, maxs = [], []
        for c, r, _, _ in self._spheres:
            c = np.asarray(c, np.float32)
            mins.append(c - r)
            maxs.append(c + r)
        for a, b, c, _, _ in self._triangles:
            mins.append(np.minimum(np.minimum(a, b), c))
            maxs.append(np.maximum(np.maximum(a, b), c))
        return np.asarray(mins, np.float32), np.asarray(maxs, np.float32)


def _normalize_rows(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1.0e-20)
