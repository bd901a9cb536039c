"""glTF 2.0 ingestion (GLB binary + text .gltf), the LoadGltf role.

The port's own copy of ``pathtracer_tpu/scene/gltf.py`` (numpy only; PIL
is imported inside the two texture functions alone). A hand-rolled parser
reproducing what the reference extracts via cgltf (win32_main.cpp:
1454-1593), for the same input class:

- GLB container or JSON .gltf document;
- buffers resolved per the spec: GLB BIN chunk (buffer 0 without uri),
  external files relative to the document, and ``data:`` base64 URIs;
- sparse accessors (base view or zeros, overlaid with sparse values);
- DFS over scene nodes via an explicit stack (push scene roots in order,
  pop LIFO, push children in order) — node ORDER is preserved because it
  determines material table order;
- node/mesh TRANSFORMS ARE IGNORED, as in the reference (positions are
  unpacked raw; cgltf_accessor_unpack_floats does not bake node matrices);
- triangles-only primitives; POSITION attribute + optional indices unpacked
  into a flat (T*3, 3) vertex array with one material index per vertex
  (mesh_t convention, ray.hpp:102-106);
- material: if the primitive has pbr_metallic_roughness and NO base-color
  texture, a new textureless material with albedo = base_color_factor.rgb
  is appended; otherwise the material index stays at the default 1 —
  which in world 5 is the sun's emissive material, a reference quirk kept
  as-is (win32_main.cpp:1504-1515).
"""

from __future__ import annotations

import base64
import json
import os
import struct
import urllib.parse
from typing import List, Optional, Tuple

import numpy as np

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8,
    5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


def parse_glb(path: str) -> Tuple[dict, bytes]:
    """Split a .glb into (gltf json dict, binary blob)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"{path}: not a GLB file")
    if version != 2:
        raise ValueError(f"{path}: unsupported GLB version {version}")
    off = 12
    doc: Optional[dict] = None
    blob = b""
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        payload = data[off + 8: off + 8 + clen]
        if ctype == _CHUNK_JSON:
            doc = json.loads(payload.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            blob = payload
        off += 8 + clen
    if doc is None:
        raise ValueError(f"{path}: missing JSON chunk")
    return doc, blob


def _resolve_buffer(buf: dict, base_dir: str, glb_blob: bytes) -> bytes:
    """One doc["buffers"] entry -> bytes (cgltf_load_buffers semantics)."""
    uri = buf.get("uri")
    if uri is None:
        return glb_blob  # GLB-stored buffer
    if uri.startswith("data:"):
        comma = uri.find(",")
        if comma < 0:
            raise ValueError("malformed data URI in glTF buffer")
        meta, payload = uri[:comma], uri[comma + 1:]
        if ";base64" in meta:
            return base64.b64decode(payload)
        return urllib.parse.unquote_to_bytes(payload)
    fname = urllib.parse.unquote(uri)
    with open(os.path.join(base_dir, fname), "rb") as f:
        return f.read()


def parse_gltf(path: str) -> Tuple[dict, List[bytes]]:
    """Load a .glb OR text .gltf into (doc, per-buffer bytes).

    Dispatches on content, not extension (cgltf_parse sniffs the GLB
    magic): files starting with the 'glTF' magic are containers, anything
    else is parsed as JSON.
    """
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"glTF":
        doc, blob = parse_glb(path)
    else:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
        blob = b""
    base_dir = os.path.dirname(os.path.abspath(path))
    buffers = [_resolve_buffer(b, base_dir, blob)
               for b in doc.get("buffers", [])]
    return doc, buffers


def _read_view(doc: dict, buffers: List[bytes], view_idx: int, *,
               byte_offset: int, count: int, ncomp: int, dtype) -> np.ndarray:
    bv = doc["bufferViews"][view_idx]
    blob = buffers[bv.get("buffer", 0)]
    base = bv.get("byteOffset", 0) + byte_offset
    elem_size = ncomp * np.dtype(dtype).itemsize
    stride = bv.get("byteStride", 0) or elem_size
    if stride == elem_size:
        out = np.frombuffer(blob, dtype=dtype, count=count * ncomp, offset=base)
        return out.reshape(count, ncomp)
    out = np.zeros((count, ncomp), dtype)
    for i in range(count):
        out[i] = np.frombuffer(blob, dtype=dtype, count=ncomp,
                               offset=base + i * stride)
    return out


def read_accessor(doc: dict, buffers, accessor_idx: int) -> np.ndarray:
    """Unpack an accessor to (count, components) — cgltf_accessor_unpack_*.

    ``buffers`` is the list from parse_gltf; a single bytes blob is also
    accepted (treated as buffer 0) for GLB-era callers. Handles sparse
    accessors (spec 3.6.2.3: base data or zeros, overlaid at the sparse
    indices) and accessors without a bufferView (all zeros).
    """
    if isinstance(buffers, (bytes, bytearray, memoryview)):
        buffers = [bytes(buffers)]
    acc = doc["accessors"][accessor_idx]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" in acc:
        out = _read_view(doc, buffers, acc["bufferView"],
                         byte_offset=acc.get("byteOffset", 0),
                         count=count, ncomp=ncomp, dtype=dtype)
    else:
        out = np.zeros((count, ncomp), dtype)
    sparse = acc.get("sparse")
    if sparse:
        n = sparse["count"]
        sidx = sparse["indices"]
        idx = _read_view(doc, buffers, sidx["bufferView"],
                         byte_offset=sidx.get("byteOffset", 0), count=n,
                         ncomp=1,
                         dtype=_COMPONENT_DTYPES[sidx["componentType"]])
        sval = sparse["values"]
        vals = _read_view(doc, buffers, sval["bufferView"],
                          byte_offset=sval.get("byteOffset", 0), count=n,
                          ncomp=ncomp, dtype=dtype)
        out = out.copy()
        out[idx.reshape(-1).astype(np.int64)] = vals
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / info.max
    return out


def _decode_image(doc: dict, buffers, base_dir: str, image_idx: int):
    """doc["images"][i] -> (H, W, 3) float32 in [0, 1] via PIL (the stbi
    role for glTF-embedded PNG/JPEG), from a bufferView or a uri
    (external file / data URI)."""
    import io as _io

    from PIL import Image

    img = doc["images"][image_idx]
    if "bufferView" in img:
        bv = doc["bufferViews"][img["bufferView"]]
        blob = buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0)
        raw = blob[off: off + bv["byteLength"]]
    else:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri[uri.find(",") + 1:])
        else:
            with open(os.path.join(base_dir,
                                   urllib.parse.unquote(uri)), "rb") as f:
                raw = f.read()
    arr = np.asarray(Image.open(_io.BytesIO(raw)).convert("RGB"), np.float32)
    return arr / 255.0


def _node_matrix(node: dict) -> np.ndarray:
    """Local 4x4 transform of a node: ``matrix`` (column-major per spec)
    or TRS composed as T * R * S (glTF 2.0 section 5.25)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    s = node.get("scale")
    if s is not None:
        m = np.diag([s[0], s[1], s[2], 1.0]) @ m
    q = node.get("rotation")
    if q is not None:
        x, y, z, w = (float(v) for v in q)  # glTF order: xyzw
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    t = node.get("translation")
    if t is not None:
        tm = np.eye(4)
        tm[:3, 3] = t
        m = tm @ m
    return m


def _load(path: str, builder, want_textures: bool,
          apply_transforms: bool = False):
    # The reference silently no-ops when cgltf fails to parse
    # (win32_main.cpp:1464-1465); match that for the WHOLE ingestion. A
    # curated exception list proved leaky under fuzzing (struct.error
    # from truncated headers, PIL's OSError from corrupt images, then
    # PIL's DecompressionBombError from forged dimensions — decoder
    # libraries own an open-ended error surface), so a malformed-input
    # parser catches everything: any failure while consuming UNTRUSTED
    # bytes is by definition a malformed file. Materials/textures
    # appended before the failure are rolled back so the builder is
    # untouched on a no-op.
    n_mats, n_texs = len(builder.materials), len(builder.textures)
    try:
        return _load_inner(path, builder, want_textures, apply_transforms)
    except Exception:
        del builder.materials[n_mats:]
        del builder.textures[n_texs:]
        return None, None, None


def _load_inner(path: str, builder, want_textures: bool,
                apply_transforms: bool = False):
    doc, buffers = parse_gltf(path)
    base_dir = os.path.dirname(os.path.abspath(path))
    points_out = []
    mats_out = []
    uvs_out = []
    any_uv = False
    tex_cache: dict = {}  # glTF image index -> builder texture index

    eye = np.eye(4)
    stack = []
    for scene in doc.get("scenes", []):
        for ni in scene.get("nodes", []):
            stack.append((ni, eye))

    nodes = doc.get("nodes", [])
    meshes = doc.get("meshes", [])
    materials = doc.get("materials", [])
    textures = doc.get("textures", [])

    # A node-graph CYCLE (malformed input) would make the while-stack spin
    # forever — non-termination escapes the loader's exception-based
    # silent-no-op contract. A visit budget bounds the walk: a valid DAG
    # visits each node at most once per distinct path, and the reference's
    # cgltf inputs are trees, so 4x node count is generous; exceeding it
    # raises into the caller's catch-all (-> no-op + builder rollback).
    visit_budget = 4 * len(nodes) + 16
    while stack:
        visit_budget -= 1
        if visit_budget < 0:
            raise ValueError("gltf node graph is cyclic or degenerate")
        ni, parent_m = stack.pop()
        node = nodes[ni]
        world_m = (parent_m @ _node_matrix(node) if apply_transforms
                   else eye)
        if "mesh" in node:
            mesh = meshes[node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                attrs = prim.get("attributes", {})
                mat_idx = 1  # reference default (win32_main.cpp:1504)
                uv_attr = None
                mi = prim.get("material")
                if mi is not None:
                    gmat = materials[mi]
                    pbr = gmat.get("pbrMetallicRoughness")
                    if pbr is not None and "baseColorTexture" not in pbr:
                        f = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
                        mat_idx = builder.add_material(albedo=(f[0], f[1], f[2]))
                    elif (want_textures and pbr is not None
                          and "baseColorTexture" in pbr):
                        # Textured materials — the reference's unrealized
                        # "load materials with textures" TODO
                        # (win32_main.cpp:172). baseColorFactor MODULATES
                        # the texel (glTF 2.0 spec), so it becomes the
                        # material albedo and the sampled texel multiplies
                        # it at shade time (integrator uv branch).
                        bct = pbr["baseColorTexture"]
                        src = textures[bct["index"]].get("source")
                        tc = bct.get("texCoord", 0)
                        uv_attr = attrs.get(f"TEXCOORD_{tc}")
                        if src is not None and uv_attr is not None:
                            if src not in tex_cache:
                                tex_cache[src] = builder.add_texture(
                                    _decode_image(doc, buffers, base_dir,
                                                  src))
                            f = pbr.get("baseColorFactor",
                                        [1.0, 1.0, 1.0, 1.0])
                            mat_idx = builder.add_material(
                                albedo=(f[0], f[1], f[2]),
                                albedo_idx=tex_cache[src])
                        else:
                            uv_attr = None
                if "POSITION" not in attrs:
                    continue
                pos = read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
                if apply_transforms:
                    pos = (pos.astype(np.float64) @ world_m[:3, :3].T
                           + world_m[:3, 3]).astype(np.float32)
                uv = None
                if uv_attr is not None:
                    uv = read_accessor(doc, buffers, uv_attr).astype(np.float32)
                if "indices" in prim:
                    idx = read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.int64)
                    tri_pts = pos[idx]  # (3*ntris, 3)
                    tri_uv = uv[idx] if uv is not None else None
                else:
                    n3 = (len(pos) // 3) * 3
                    tri_pts = pos[:n3]
                    tri_uv = uv[:n3] if uv is not None else None
                points_out.append(tri_pts.reshape(-1, 3))
                mats_out.append(np.full((len(tri_pts),), mat_idx, np.int32))
                if tri_uv is not None:
                    any_uv = True
                    uvs_out.append(tri_uv.reshape(-1, 2)[:, :2])
                else:
                    uvs_out.append(np.zeros((len(tri_pts), 2), np.float32))
        for child in node.get("children", []):
            stack.append((child, world_m))

    if not points_out:
        return None, None, None
    uvs = np.concatenate(uvs_out, 0) if any_uv else None
    return np.concatenate(points_out, 0), np.concatenate(mats_out, 0), uvs


def load_gltf_triangles(path: str, builder) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """LoadGltf (win32_main.cpp:1454-1593): returns (points (T*3,3) float32,
    mat_indices (T*3,) int32) appending any new materials to ``builder``.
    Accepts .glb or text .gltf. Returns (None, None) when the file is
    absent/unreadable (the reference silently no-ops on parse failure,
    win32_main.cpp:1464-1465). Textured materials keep the reference's
    default-1 quirk; use :func:`load_gltf_textured` for real bindings."""
    pts, mats, _ = _load(path, builder, want_textures=False)
    return pts, mats


def load_gltf_textured(path: str, builder, apply_transforms: bool = False):
    """LoadGltf + the reference's unrealized "load materials with
    textures" TODO (win32_main.cpp:172): primitives whose material has a
    pbr baseColorTexture AND texcoords get the image decoded into the
    builder's texture stack, a material with albedo = baseColorFactor and
    albedo_idx = that texture, and per-vertex UVs returned for
    interpolation at hit time. Returns (points (T*3,3), mats (T*3,),
    uvs (T*3,2) | None); untextured primitives keep the plain path's
    semantics and contribute (0,0) UVs.

    ``apply_transforms`` additionally bakes each node's world matrix
    (``matrix`` or T*R*S, accumulated down the hierarchy) into the
    positions — the reference (and cgltf_accessor_unpack) ignores node
    transforms, which its own TODO flags under 'instance transforms'
    (win32_main.cpp:189-190); OFF keeps that parity."""
    return _load(path, builder, want_textures=True,
                 apply_transforms=apply_transforms)


# GLB-era name; worlds.py and external callers may use either.
load_glb_triangles = load_gltf_triangles


def split_glb(glb_path: str, out_gltf: str, out_bin: Optional[str] = None) -> None:
    """Convert a .glb container to text .gltf + external .bin (the inverse
    packing; useful for tests and asset pipelines). Buffer entries without
    a uri gain one pointing at the written .bin."""
    doc, blob = parse_glb(glb_path)
    if out_bin is None:
        out_bin = os.path.splitext(out_gltf)[0] + ".bin"
    with open(out_bin, "wb") as f:
        f.write(blob)
    rel = os.path.basename(out_bin)
    doc = json.loads(json.dumps(doc))  # deep copy
    for buf in doc.get("buffers", []):
        if "uri" not in buf:
            buf["uri"] = rel
    with open(out_gltf, "w", encoding="utf-8") as f:
        json.dump(doc, f)
