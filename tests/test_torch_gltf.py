"""The port's glTF loader (scene/gltf.py) against the JAX package's, on GLB
and text .gltf documents these tests write themselves: a data-URI buffer,
a sparse accessor, an external .bin under an escaped URI, a GLB with
indices, several nodes and base-colour materials, its split_glb twin, and
the missing-file and malformed-file no-ops (the builder left untouched).
Points, material indices and the appended materials must be equal (the
twins of tests/test_io.py:83-190, without mario.glb)."""

import base64
import json
import struct

import numpy as np
import pytest

from pathtracer_tpu.scene import gltf as jgltf
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu_torch.scene import gltf as tgltf
from pathtracer_tpu_torch.scene import schema as tschema
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def _doc_with_buffer(pos, sparse=None):
    """One triangle-list primitive whose POSITION accessor reads a data-URI
    buffer, with an optional sparse overlay (tests/test_io.py's document)."""
    blob = np.asarray(pos, np.float32).tobytes()
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(blob)}]
    accessors = [{"bufferView": 0, "componentType": 5126,
                  "count": len(pos), "type": "VEC3"}]
    if sparse is not None:
        s_idx, s_val = sparse
        ib = np.asarray(s_idx, np.uint32).tobytes()
        vb = np.asarray(s_val, np.float32).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(ib)})
        views.append({"buffer": 0, "byteOffset": len(blob) + len(ib),
                      "byteLength": len(vb)})
        blob += ib + vb
        accessors[0]["sparse"] = {
            "count": len(s_idx),
            "indices": {"bufferView": 1, "componentType": 5125},
            "values": {"bufferView": 2},
        }
    return {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
        "bufferViews": views,
        "accessors": accessors,
    }


def write_glb(path, n_tris=120, seed=3):
    """A GLB of three indexed primitives in a small node tree: two with
    base-colour materials (appended to the builder) and one without a
    material (the reference's default index 1); vertices from a numpy
    seed, inside the world volume."""
    rng = np.random.RandomState(seed)
    blob, views, accessors, prims = b"", [], [], []
    for p in range(3):
        n_v = n_tris + 2
        pos = ((rng.rand(n_v, 3) - 0.5) * 3.0 + [0.0, 0.0, 1.5]
               ).astype(np.float32)
        idx = np.stack([np.arange(n_tris), np.arange(1, n_tris + 1),
                        np.arange(2, n_tris + 2)], 1).astype(np.uint16)
        for arr, ctype, typ in ((pos, 5126, "VEC3"), (idx.reshape(-1), 5123,
                                                      "SCALAR")):
            raw = arr.tobytes()
            raw += b"\0" * (-len(raw) % 4)
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": arr.nbytes})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": ctype,
                              "count": len(arr), "type": typ})
            blob += raw
        prim = {"attributes": {"POSITION": 2 * p}, "indices": 2 * p + 1}
        if p < 2:
            prim["material"] = p
        prims.append(prim)
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "children": [1]}, {"mesh": 1, "children": [2]},
                  {"mesh": 2}],
        "meshes": [{"primitives": [prims[0]]}, {"primitives": [prims[1]]},
                   {"primitives": [prims[2]]}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.3, 0.2, 1]}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.5, 0.9, 1]}}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return 3 * 3 * n_tris  # points: three primitives of n_tris triangles


def _load_both(path):
    """(JAX builder, its points and mats, port builder, its points and
    mats), each loader on its own builder."""
    jb, tb = JWorldBuilder(), tschema.WorldBuilder()
    for b in (jb, tb):  # a sky and a sun, as world 5 has
        b.add_material(emit=(0.1, 0.2, 0.3))
        b.add_material(emit=(15.0, 15.0, 15.0))
    jp, jm = jgltf.load_gltf_triangles(path, jb)
    tp, tm = tgltf.load_gltf_triangles(path, tb)
    return jb, jp, jm, tb, tp, tm


def _assert_same_load(path):
    jb, jp, jm, tb, tp, tm = _load_both(path)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(jm, tm)
    assert tp.dtype == np.float32 and tm.dtype == np.int32
    assert ([m.albedo for m in jb.materials]
            == [m.albedo for m in tb.materials])
    return tp, tm, tb


def test_data_uri_buffer(tmp_path):
    pos = np.arange(9, dtype=np.float32).reshape(3, 3)
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(_doc_with_buffer(pos)))
    pts, mats, _ = _assert_same_load(str(p))
    np.testing.assert_array_equal(pts, pos)
    assert (mats == 1).all()  # the reference's default material


def test_sparse_accessor_overlay(tmp_path):
    pos = np.zeros((6, 3), np.float32)
    rows = np.array([[9, 9, 9], [7, 7, 7]], np.float32)
    p = tmp_path / "sparse.gltf"
    p.write_text(json.dumps(_doc_with_buffer(pos, sparse=([1, 4], rows))))
    pts, _, _ = _assert_same_load(str(p))
    want = pos.copy()
    want[[1, 4]] = rows
    np.testing.assert_array_equal(pts, want)


def test_external_bin_with_escaped_uri(tmp_path):
    pos = np.arange(9, dtype=np.float32).reshape(3, 3)
    doc = _doc_with_buffer(pos)
    blob = pos.tobytes()
    (tmp_path / "my data.bin").write_bytes(blob)
    doc["buffers"] = [{"byteLength": len(blob), "uri": "my%20data.bin"}]
    p = tmp_path / "ext.gltf"
    p.write_text(json.dumps(doc))
    pts, _, _ = _assert_same_load(str(p))
    np.testing.assert_array_equal(pts, pos)


def test_glb_and_split_glb(tmp_path):
    """A written GLB through both loaders, and split_glb's text twin of it
    (the port's split, read back by both)."""
    glb = str(tmp_path / "mesh.glb")
    n_pts = write_glb(glb)
    jdoc, jblob = jgltf.parse_glb(glb)
    tdoc, tblob = tgltf.parse_glb(glb)
    assert jdoc == tdoc and jblob == tblob
    pts, mats, tb = _assert_same_load(glb)
    assert pts.shape == (n_pts, 3)
    # two appended base-colour materials; the material-less primitive
    # keeps index 1
    assert len(tb.materials) == 4 and sorted(set(mats.tolist())) == [1, 2, 3]
    out = str(tmp_path / "mesh.gltf")
    tgltf.split_glb(glb, out)
    tpts, tmats, _ = _assert_same_load(out)
    np.testing.assert_array_equal(tpts, pts)
    np.testing.assert_array_equal(tmats, mats)


@pytest.mark.parametrize("content", [None, b"glTF\x02\x00\x00\x00\x10",
                                     b"not a gltf document"],
                         ids=["missing", "truncated", "garbage"])
def test_unreadable_file_is_a_noop(tmp_path, content):
    """An absent or malformed file returns (None, None) and leaves the
    builder as it was, in both packages."""
    p = tmp_path / "bad.glb"
    if content is not None:
        p.write_bytes(content)
    jb, jp, jm, tb, tp, tm = _load_both(str(p))
    assert jp is jm is tp is tm is None
    assert len(tb.materials) == len(jb.materials) == 2
    assert tb.textures == [] and jb.textures == []
