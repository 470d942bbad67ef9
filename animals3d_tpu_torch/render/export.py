"""Mesh and material export: OBJ/MTL with a baked texture atlas (port of
`animals3d_tpu.render.export`).

Reference: `obj.py:128-175` (write_obj), `material.py:106-141` (save_mtl),
`render.py:342-360` (render_uv, which bakes the texture MLP to an atlas by
rasterizing in UV space). No UV-space rasterization here: each face gets a
cell of the atlas, and every atlas pixel maps analytically (cell → face →
barycentric → canonical position) onto the surface, so baking is one
texture-MLP evaluation over the atlas' pixels. `map_uv_reference` and
`bake_texture_atlas_reference` reproduce the reference's per-tet tiling
(`map_uv`, `dmtet.py:69-98`). The atlas layout is computed on the host in
numpy, the texture MLP runs on the mesh's device, and the files are
written on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _eval_texture(texture_fn, pos, device):
    """`texture_fn` at the (..., 3) float positions `pos` (numpy), as one
    (1, P, 3) float32 batch on `device` → (P, C) numpy."""
    with torch.no_grad():
        tex = texture_fn(torch.as_tensor(
            pos.reshape(1, -1, 3).astype(np.float32), device=device))
    return _np(tex.float()).reshape(pos.shape[:-1] + (-1,))


def face_cell_uvs(num_faces: int, pad: float = 0.45):
    """Cell-corner UVs per face: cell grid N×N, face f at (f%N, f//N).
    Returns (uvs (F, 3, 2) in [0,1], N)."""
    N = int(np.ceil(np.sqrt(max(num_faces, 1))))
    f = np.arange(num_faces)
    x = (f % N).astype(np.float32)
    y = (f // N).astype(np.float32)
    # triangle corners inside the cell (lower-left half, with padding)
    c0 = np.stack([x + 0.05, y + 0.05], -1)
    c1 = np.stack([x + 0.05 + 2 * pad, y + 0.05], -1)
    c2 = np.stack([x + 0.05, y + 0.05 + 2 * pad], -1)
    uvs = np.stack([c0, c1, c2], 1) / N
    return uvs.astype(np.float32), N


def map_uv_reference(face_gidx: np.ndarray, max_idx: int):
    """Exact reference atlas tiling (`map_uv`, `dmtet.py:69-98`): one cell
    per global TET on an N×N grid, N = ceil(sqrt((max_idx+1)//2)); the two
    triangles of a tet share the cell — gid%2==0 spans padded-square corners
    (0,1,2), gid%2==1 spans (0,2,3). Returns per-face UV triples (F, 3, 2).
    """
    N = int(np.ceil(np.sqrt((max_idx + 1) // 2)))
    pad = 0.9 / N
    tet_idx = face_gidx // 2
    x = (tet_idx % N).astype(np.float32) / N
    y = (tet_idx // N).astype(np.float32) / N
    c0 = np.stack([x, y], -1)
    c1 = np.stack([x + pad, y], -1)
    c2 = np.stack([x + pad, y + pad], -1)
    c3 = np.stack([x, y + pad], -1)
    tri1 = (face_gidx % 2).astype(bool)[:, None, None]
    uvs = np.where(tri1, np.stack([c0, c2, c3], 1), np.stack([c0, c1, c2], 1))
    return uvs.astype(np.float32), N


def bake_texture_atlas_reference(mesh, texture_fn, max_idx: int,
                                 atlas_res: int = 256):
    """Bake into the reference `map_uv` tiling (analytic, no UV-space
    rasterizer): each atlas pixel → tet cell → face via a searchsorted
    lookup on the mesh's (ascending) face_gidx → barycentric position.
    Note the reference bakes 256² against an N²≈num_tets cell grid
    (`material.py:106`), so cells are sub-pixel at production grid
    resolutions — identical layout, identical (low) bake quality."""
    face_gidx = _np(mesh.face_gidx)
    f_valid = _np(mesh.f_valid)
    gids = face_gidx[f_valid]
    faces = _np(mesh.t_pos_idx)[f_valid]
    N = int(np.ceil(np.sqrt((max_idx + 1) // 2)))

    H = W = atlas_res
    ys = (np.arange(H) + 0.5) / H
    xs = (np.arange(W) + 0.5) / W
    px, py = np.meshgrid(xs, ys)
    cx = np.clip((px * N).astype(np.int64), 0, N - 1)
    cy = np.clip((py * N).astype(np.int64), 0, N - 1)
    tet = cy * N + cx
    # local coords in pad units; diagonal c0→c2 splits the two triangles
    lx = np.clip((px * N - cx) / 0.9, 0, 1)
    ly = np.clip((py * N - cy) / 0.9, 0, 1)
    is_tri1 = ly > lx
    gid = tet * 2 + is_tri1.astype(np.int64)
    pos_idx = np.searchsorted(gids, gid)
    pos_idx_c = np.clip(pos_idx, 0, max(len(gids) - 1, 0))
    hit = (len(gids) > 0) & (gids[pos_idx_c] == gid)
    fsel = np.where(hit, pos_idx_c, 0)

    # barycentrics: tri0 corners (0,0),(1,0),(1,1); tri1 (0,0),(1,1),(0,1)
    l_b = np.where(is_tri1, lx, lx - ly)
    l_c = np.where(is_tri1, ly - lx, ly)
    l_a = 1.0 - l_b - l_c
    v_tex = _np((mesh.v_tex if mesh.v_tex is not None
                 else mesh.v_pos)[0])
    tri = v_tex[faces[fsel]] if len(gids) else np.zeros((H, W, 3, 3))
    pos = (tri[..., 0, :] * l_a[..., None] + tri[..., 1, :] * l_b[..., None]
           + tri[..., 2, :] * l_c[..., None])
    tex = _eval_texture(texture_fn, pos, mesh.v_pos.device)[..., :3]
    tex = np.where(hit[..., None], tex, 0.0)
    return np.clip(tex, 0, 1), map_uv_reference(gids, max_idx)[0]


def bake_texture_atlas(mesh, texture_fn, atlas_res: int = 1024):
    """Bake `texture_fn(tex_pos (1, P, 3)) → (1, P, C)` into an atlas
    image. Every atlas pixel inside a face cell maps to barycentric
    coordinates of that face's triangle; positions come from the mesh's
    canonical v_tex. Returns (atlas (H, W, 3) numpy, uvs (F, 3, 2))."""
    faces = _np(mesh.t_pos_idx)
    F = faces.shape[0]
    uvs, N = face_cell_uvs(F)

    H = W = atlas_res
    ys = (np.arange(H) + 0.5) / H
    xs = (np.arange(W) + 0.5) / W
    px, py = np.meshgrid(xs, ys)
    cell_x = np.clip((px * N).astype(np.int64), 0, N - 1)
    cell_y = np.clip((py * N).astype(np.int64), 0, N - 1)
    fid = np.clip(cell_y * N + cell_x, 0, F - 1)          # (H, W)

    # in-cell coordinates → barycentrics of the cell triangle
    lx = px * N - cell_x - 0.05
    ly = py * N - cell_y - 0.05
    u = np.clip(lx / 0.9, 0, 1)
    v = np.clip(ly / 0.9, 0, 1)
    # fold upper half onto the triangle (clamp u+v <= 1)
    s = np.clip(u + v, 1e-6, None)
    scale = np.minimum(1.0, 1.0 / s)
    u, v = u * scale, v * scale
    w0 = 1.0 - u - v

    v_tex = _np(mesh.v_tex[0])                            # (V, 3)
    tri = v_tex[faces[fid]]                               # (H, W, 3, 3)
    pos = (tri[..., 0, :] * w0[..., None] + tri[..., 1, :] * u[..., None]
           + tri[..., 2, :] * v[..., None])
    tex = _eval_texture(texture_fn, pos, mesh.v_pos.device)[..., :3]
    return np.clip(tex, 0, 1), uvs


def save_obj_with_mtl(path: str, mesh, texture_fn=None, atlas_res: int = 512,
                      batch_index: int = 0, uv_layout: str = "dense",
                      max_gidx: int | None = None):
    """Write `<path>.obj` + `.mtl` + baked `_kd.png` (reference layout:
    `obj.py:128-175`, `material.py:106-141`). Capacity padding is dropped
    and vertex indices are remapped.

    uv_layout: "dense" (default) packs valid faces into a dense cell grid —
    full use of the atlas; "reference" reproduces the reference's per-tet
    `map_uv` tiling exactly (requires mesh.face_gidx + `max_gidx` = 2·n_tets;
    at production grid resolutions cells are sub-pixel, exactly as in the
    reference)."""
    v_valid = _np(mesh.v_valid)
    f_valid = _np(mesh.f_valid)
    verts = _np(mesh.v_pos[min(batch_index,
                               mesh.v_pos.shape[0] - 1)])[v_valid]
    remap = np.cumsum(v_valid) - 1
    faces = _np(mesh.t_pos_idx)[f_valid]
    faces = remap[faces]

    base = path[:-4] if path.endswith(".obj") else path
    name = os.path.basename(base)

    uv_lines = []
    mtl = texture_fn is not None
    if mtl:
        if uv_layout == "reference":
            if mesh.face_gidx is None or max_gidx is None:
                raise ValueError("uv_layout='reference' needs face_gidx "
                                 "and max_gidx")
            atlas, uvs = bake_texture_atlas_reference(
                mesh, texture_fn, max_gidx, atlas_res)    # (Fv, 3, 2)
        else:
            atlas, uvs_all = bake_texture_atlas(mesh, texture_fn, atlas_res)
            uvs = uvs_all[f_valid]                        # (Fv, 3, 2)
        from PIL import Image
        Image.fromarray((atlas * 255).astype(np.uint8)[::-1]) \
            .save(base + "_kd.png")
        with open(base + ".mtl", "w") as f:
            f.write(f"newmtl material_0\nKd 1 1 1\nKs 0 0 0\n"
                    f"map_Kd {name}_kd.png\n")

    with open(base + ".obj", "w") as f:
        if mtl:
            f.write(f"mtllib {name}.mtl\nusemtl material_0\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if mtl:
            for tri_uv in uvs:
                for uv in tri_uv:
                    f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
            for i, tri in enumerate(faces):
                a, b, c = tri + 1
                f.write(f"f {a}/{3 * i + 1} {b}/{3 * i + 2} {c}/{3 * i + 3}\n")
        else:
            for tri in faces:
                a, b, c = tri + 1
                f.write(f"f {a} {b} {c}\n")
    return base + ".obj"


def load_obj(path: str):
    """Minimal OBJ reader (verts + faces [+ uvs]) — `obj.py:32-127`."""
    verts, faces, uvs, uv_idx = [], [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                uvs.append([float(x) for x in p[1:3]])
            elif p[0] == "f":
                idx = [q.split("/") for q in p[1:4]]
                faces.append([int(q[0]) - 1 for q in idx])
                if len(idx[0]) > 1 and idx[0][1]:
                    uv_idx.append([int(q[1]) - 1 for q in idx])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(uvs, np.float32) if uvs else None,
            np.asarray(uv_idx, np.int32) if uv_idx else None)


def load_mtl(path: str, clear_ks: bool = True):
    """Parse a `.mtl` file into material dicts (reference `load_mtl`,
    `material.py:54-102`): per `newmtl` block, scalar fields become float
    arrays, `map_kd`/`map_ks`/`bump` load textures relative to the file;
    constants are promoted to 1×1 maps so `kd`/`ks` are always textures;
    `kd` converts sRGB→linear; `clear_ks` zeroes the hijacked ORM occlusion
    (red) channel. Textures are float32 tensors on the CPU."""
    import re
    from PIL import Image

    from animals3d_tpu_torch.ops.shading import srgb_to_rgb

    mtl_dir = os.path.dirname(path)

    def load_tex(fn, channels=3, lambda_fn=None):
        img = np.asarray(Image.open(os.path.join(mtl_dir, fn)),
                         np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] < channels:
            img = np.repeat(img, channels, -1)
        img = img[..., :channels]
        if lambda_fn is not None:
            img = lambda_fn(img)
        return torch.from_numpy(np.ascontiguousarray(img, np.float32))

    materials = []
    with open(path) as f:
        for line in f:
            parts = re.split(r"[ \t]+", line.strip())
            if not parts or not parts[0]:
                continue
            prefix, data = parts[0].lower(), parts[1:]
            if "newmtl" in prefix:
                materials.append({"name": data[0]})
            elif materials:
                if prefix in ("bsdf", "map_kd", "map_ks", "bump"):
                    materials[-1][prefix] = data[0]
                else:
                    try:
                        materials[-1][prefix] = np.asarray(
                            [float(d) for d in data], np.float32)
                    except ValueError:
                        pass

    for mat in materials:
        mat.setdefault("bsdf", "pbr")
        if "map_kd" in mat:
            mat["kd"] = load_tex(mat["map_kd"])
        else:
            mat["kd"] = torch.as_tensor(
                mat.get("kd", np.ones(3, np.float32))).reshape(1, 1, -1)
        if "map_ks" in mat:
            mat["ks"] = load_tex(mat["map_ks"], channels=3)
        else:
            mat["ks"] = torch.as_tensor(
                mat.get("ks", np.zeros(3, np.float32))).reshape(1, 1, -1)
        if "bump" in mat:
            mat["normal"] = load_tex(mat["bump"], channels=3,
                                     lambda_fn=lambda x: x * 2 - 1)
        mat["kd"] = srgb_to_rgb(mat["kd"])
        if clear_ks:
            mat["ks"] = mat["ks"].clone()
            mat["ks"][..., 0] = 0.0
    return materials
