"""glTF 2.0 loader (.gltf JSON + external/embedded buffers, and .glb).

Replaces the reference's `gltf` crate import path (hittable.rs:556-633)
with a hand-rolled host-side parser: JSON index, buffer loading (external
.bin files, base64 data URIs, GLB BIN chunk), accessor decoding for
indices / POSITION / TEXCOORD_0, PBR metallic-roughness materials and
their base-color textures (decoded by io.png_io.load_image from buffer
views or URIs).

Reference behaviors matched (each behind honest defaults):
- Every primitive's material maps to Metal with fuzz = roughness_factor
  (Material::from_gltf, material.rs:20-33 — base-color texture if present,
  else solid base-color factor; metallic factor ignored).  That quirky
  mapping lives in ``material_from_gltf`` and is applied by scene code via
  CompatConfig.gltf_all_metal; this loader just reports the PBR data.
- No node-hierarchy transforms by default (the reference reads mesh
  primitives directly, ignoring nodes).  ``apply_node_transforms=True``
  walks the scene graph properly — a corrected mode the reference lacks.
- Missing TEXCOORD_0: the reference panics ("no tex coords",
  hittable.rs:590); we substitute default UVs and keep loading.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def load_gltf(path: str, apply_node_transforms: bool = False) -> list[dict]:
    """Parse a glTF/GLB file into flat primitive records.

    Returns a list of primitives, each::

        {"vertices": f32[n,3,3], "uvs": f32[n,3,2] | None,
         "base_color_factor": f32[4], "base_color_image": f32[h,w,3] | None,
         "metallic": float, "roughness": float, "name": str}
    """
    doc, buffers = _read_document(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    buffer_data = [_load_buffer(b, base_dir, buffers) for b in doc.get("buffers", [])]

    def accessor_array(idx: int) -> np.ndarray:
        acc = doc["accessors"][idx]
        view = doc["bufferViews"][acc["bufferView"]]
        data = buffer_data[view["buffer"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dtype().itemsize * n_comp
        raw = np.frombuffer(
            data, dtype=np.uint8, count=max(stride * (count - 1), 0) + dtype().itemsize * n_comp,
            offset=offset,
        )
        if stride == dtype().itemsize * n_comp:
            arr = raw.view(dtype)[: count * n_comp].reshape(count, n_comp)
        else:  # interleaved
            arr = np.lib.stride_tricks.as_strided(
                raw.view(np.uint8), shape=(count, dtype().itemsize * n_comp), strides=(stride, 1)
            ).copy().view(dtype).reshape(count, n_comp)
        return np.ascontiguousarray(arr)

    def image_array(idx: int) -> np.ndarray | None:
        from rt_tpu.io.png_io import load_image

        img = doc["images"][idx]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                return load_image(base64.b64decode(uri.split(",", 1)[1]))
            return load_image(os.path.join(base_dir, uri))
        view = doc["bufferViews"][img["bufferView"]]
        data = buffer_data[view["buffer"]]
        off = view.get("byteOffset", 0)
        return load_image(bytes(data[off : off + view["byteLength"]]))

    # Node transforms (corrected mode): world matrix per mesh instance.
    mesh_transforms: dict[int, list[np.ndarray]] = {}
    if apply_node_transforms:
        for scene_def in doc.get("scenes", [{}]):
            for root in scene_def.get("nodes", []):
                _walk_nodes(doc, root, np.eye(4, dtype=np.float32), mesh_transforms)

    prims: list[dict] = []
    image_cache: dict[int, np.ndarray] = {}
    for mesh_idx, mesh in enumerate(doc.get("meshes", [])):
        transforms = mesh_transforms.get(mesh_idx, [np.eye(4, dtype=np.float32)])
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            positions = accessor_array(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                indices = accessor_array(prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                indices = np.arange(len(positions), dtype=np.uint32)
            n_tris = len(indices) // 3
            tri_idx = indices[: n_tris * 3].reshape(n_tris, 3)

            uvs = None
            if "TEXCOORD_0" in attrs:
                tex = accessor_array(attrs["TEXCOORD_0"]).astype(np.float32)
                uvs = tex[tri_idx]

            mat = {}
            if "material" in prim:
                mat = doc["materials"][prim["material"]]
            pbr = mat.get("pbrMetallicRoughness", {})
            base_color = np.asarray(
                pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float32
            )
            base_image = None
            if "baseColorTexture" in pbr:
                tex_idx = pbr["baseColorTexture"]["index"]
                src = doc["textures"][tex_idx].get("source")
                if src is not None:
                    if src not in image_cache:
                        image_cache[src] = image_array(src)
                    base_image = image_cache[src]

            for world in transforms:
                verts = positions[tri_idx]
                if apply_node_transforms:
                    flat = verts.reshape(-1, 3)
                    flat = flat @ world[:3, :3].T + world[:3, 3]
                    verts = flat.reshape(-1, 3, 3)
                prims.append(
                    {
                        "vertices": np.ascontiguousarray(verts, np.float32),
                        "uvs": uvs,
                        "base_color_factor": base_color,
                        "base_color_image": base_image,
                        "metallic": float(pbr.get("metallicFactor", 1.0)),
                        "roughness": float(pbr.get("roughnessFactor", 1.0)),
                        "name": mesh.get("name", f"mesh{mesh_idx}"),
                    }
                )
    return prims


def material_from_gltf(builder, prim: dict, compat_all_metal: bool = True) -> int:
    """Create the material for a glTF primitive on a SceneBuilder.

    compat_all_metal=True replicates Material::from_gltf exactly
    (material.rs:20-33): always Metal, fuzz = roughness, base-color texture
    or factor; metallic factor ignored.  False gives a saner mapping:
    metallic >= 0.5 -> metal(fuzz=roughness), else lambertian.
    """
    if prim["base_color_image"] is not None:
        tex = builder.image_texture(prim["base_color_image"])
    else:
        tex = builder.solid_color(prim["base_color_factor"][:3])
    if compat_all_metal or prim["metallic"] >= 0.5:
        return builder.metal(tex, prim["roughness"])
    return builder.lambertian(tex)


def add_gltf_to_scene(
    builder,
    path: str,
    compat_all_metal: bool = True,
    apply_node_transforms: bool = False,
    transform: np.ndarray | None = None,
) -> int:
    """Load a glTF file and append its triangles to ``builder``; returns the
    triangle count (reference analog: the load_gltf -> Vec<Triangle> ->
    shapes.push loop, hittable.rs:556-633 + scenes.rs:429-438)."""
    count = 0
    for prim in load_gltf(path, apply_node_transforms):
        mat = material_from_gltf(builder, prim, compat_all_metal)
        verts = prim["vertices"]
        if transform is not None:
            t = np.asarray(transform, np.float32)
            flat = verts.reshape(-1, 3) @ t[:3, :3].T
            verts = flat.reshape(-1, 3, 3)
        builder.add_triangles(verts, prim["uvs"], mat)
        count += len(verts)
    return count


def _read_document(path: str) -> tuple[dict, bytes | None]:
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # GLB container
            magic, version, _length = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67 and version == 2, "unsupported GLB"
            doc = None
            bin_chunk = None
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                chunk_len, chunk_type = struct.unpack("<II", header)
                payload = f.read(chunk_len)
                if chunk_type == 0x4E4F534A:  # JSON
                    doc = json.loads(payload)
                elif chunk_type == 0x004E4942:  # BIN
                    bin_chunk = payload
            assert doc is not None, "GLB missing JSON chunk"
            return doc, bin_chunk
        return json.load(open(path)), None


def _load_buffer(buffer_def: dict, base_dir: str, glb_bin: bytes | None) -> bytes:
    uri = buffer_def.get("uri")
    if uri is None:
        assert glb_bin is not None, "buffer without URI outside GLB"
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _walk_nodes(doc, node_idx, parent, out: dict):
    node = doc["nodes"][node_idx]
    local = np.eye(4, dtype=np.float32)
    if "matrix" in node:
        local = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    else:
        t = node.get("translation", [0, 0, 0])
        r = node.get("rotation", [0, 0, 0, 1])  # xyzw quaternion
        s = node.get("scale", [1, 1, 1])
        local = _trs_matrix(t, r, s)
    world = parent @ local
    if "mesh" in node:
        out.setdefault(node["mesh"], []).append(world)
    for child in node.get("children", []):
        _walk_nodes(doc, child, world, out)


def _trs_matrix(t, r, s) -> np.ndarray:
    x, y, z, w = r
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m
