"""Heat-method geodesic distances (scipy sparse, host-side; the port's copy
of garmentnets_tpu/ops/geodesic.py).

Replaces potpourri3d's MeshHeatMethodDistanceSolver (C++ geometry-central)
used by the reference for geodesic-RMS eval (common/potpourri3d_util.py:5-15,
eval.py:736). Implements Crane et al., "Geodesics in Heat": one-time
sparse factorization of the heat and Poisson systems, then two triangular
solves per source vertex.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


class MeshHeatMethodDistanceSolver:
    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 t_coef: float = 1.0):
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        nv = len(verts)
        self.verts = verts
        self.faces = faces

        vi = [verts[faces[:, k]] for k in range(3)]
        # edge vectors opposite to each corner
        e = [vi[(k + 2) % 3] - vi[(k + 1) % 3] for k in range(3)]
        # face areas / normals
        n = np.cross(e[1], e[2])
        double_area = np.linalg.norm(n, axis=1)
        double_area = np.maximum(double_area, 1e-12)
        self.face_area = double_area / 2
        self.face_normal = n / double_area[:, None]

        # cotangents at each corner: cot(angle at corner k)
        cots = []
        for k in range(3):
            a = -e[(k + 1) % 3]
            b = e[(k + 2) % 3]
            cos_ = np.einsum("ij,ij->i", a, b)
            sin_ = np.linalg.norm(np.cross(a, b), axis=1)
            cots.append(cos_ / np.maximum(sin_, 1e-12))
        cots = np.stack(cots, axis=1)  # [F, 3]

        # cotan Laplacian (positive semidefinite): L = D - W
        rows, cols, vals = [], [], []
        for k in range(3):
            i = faces[:, (k + 1) % 3]
            j = faces[:, (k + 2) % 3]
            w = 0.5 * cots[:, k]
            rows += [i, j, i, j]
            cols += [j, i, i, j]
            vals += [-w, -w, w, w]
        L = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(nv, nv)).tocsc()
        self.L = L

        # lumped mass matrix
        mass = np.zeros(nv)
        for k in range(3):
            np.add.at(mass, faces[:, k], self.face_area / 3)
        mass = np.maximum(mass, 1e-12)
        self.mass = mass

        # time step: mean edge length squared
        el = np.concatenate([np.linalg.norm(ek, axis=1) for ek in e])
        t = t_coef * float(np.mean(el)) ** 2

        A_heat = sp.diags(mass) + t * L
        A_pois = (L + sp.eye(nv) * 1e-9).tocsc()
        self._heat_solve = spla.factorized(A_heat.tocsc())
        self._pois_solve = spla.factorized(A_pois)

        # per-face gradient helpers: grad u = sum_k u_k (N x e_k) / (2A)
        self._grad_vec = [
            np.cross(self.face_normal, e[k]) / (2 * self.face_area[:, None])
            for k in range(3)]

        # source-independent divergence geometry, precomputed once: for
        # each face corner i the adjacent edges e_ij, e_il and the
        # cotangents of the opposite angles
        self._div_geom = []
        for k in range(3):
            i = faces[:, k]
            j = faces[:, (k + 1) % 3]
            l = faces[:, (k + 2) % 3]
            e_ij = verts[j] - verts[i]
            e_il = verts[l] - verts[i]

            def cot_at(a_idx, b_idx, c_idx):
                a = verts[b_idx] - verts[a_idx]
                b = verts[c_idx] - verts[a_idx]
                cos_ = np.einsum("ij,ij->i", a, b)
                sin_ = np.linalg.norm(np.cross(a, b), axis=1)
                return cos_ / np.maximum(sin_, 1e-12)

            cot_l = cot_at(l, i, j)   # angle at l, opposite edge ij
            cot_j = cot_at(j, i, l)   # angle at j, opposite edge il
            self._div_geom.append((i, e_ij, e_il, cot_l, cot_j))

    def compute_distance_multi(self, source_idxs) -> np.ndarray:
        """Geodesic distance fields from several sources at once: one
        multi-RHS triangular solve per system (BLAS-3) instead of a python
        loop of single solves, with the gradient/divergence stages
        broadcast over the source axis. Returns [n_sources, n_verts]."""
        source_idxs = np.asarray(source_idxs, np.int64)
        nv = len(self.verts)
        ns = len(source_idxs)
        delta = np.zeros((nv, ns))
        delta[source_idxs, np.arange(ns)] = 1.0
        u = self._heat_solve(delta)                        # [nv, ns]

        # normalized negative gradient per face (per source)
        grad = np.zeros((ns, len(self.faces), 3))
        for k in range(3):
            grad += (u[self.faces[:, k]].T[:, :, None]
                     * self._grad_vec[k][None])
        norm = np.linalg.norm(grad, axis=2, keepdims=True)
        X = -grad / np.maximum(norm, 1e-12)                # [ns, F, 3]

        # integrated divergence at vertices
        div = np.zeros((ns, nv))
        for (i, e_ij, e_il, cot_l, cot_j) in self._div_geom:
            contrib = 0.5 * (cot_l * np.einsum("fj,sfj->sf", e_ij, X)
                             + cot_j * np.einsum("fj,sfj->sf", e_il, X))
            np.add.at(div, (slice(None), i), contrib)

        phi = self._pois_solve(div.T)                      # [nv, ns]
        phi = phi - phi[source_idxs, np.arange(ns)]
        # sign of the Poisson solution is arbitrary
        flip = phi.mean(axis=0) < 0
        phi[:, flip] = -phi[:, flip]
        return np.maximum(phi, 0.0).T

    def compute_distance(self, source_idx: int) -> np.ndarray:
        return self.compute_distance_multi([int(source_idx)])[0]


def geodesic_matrix(verts, faces, vert_idxs, chunk: int = 64) -> np.ndarray:
    """Pairwise geodesic distances between selected vertices
    (reference common/potpourri3d_util.py:5-15). Sources are solved in
    chunks through the multi-RHS path (chunking bounds the [n, F, 3]
    gradient intermediates)."""
    solver = MeshHeatMethodDistanceSolver(verts, faces)
    vert_idxs = np.asarray(vert_idxs, np.int64)
    n = len(vert_idxs)
    out = np.zeros((n, n))
    for s in range(0, n, chunk):
        sel = vert_idxs[s:s + chunk]
        all_d = solver.compute_distance_multi(sel)
        out[s:s + chunk] = all_d[:, vert_idxs]
    return out
