"""Instant-NGP (.ingp) gaussian-mixture exporter.

Reference: threedgrut/export/ingp_exporter.py:27-76 — a gzip-compressed
msgpack dict carrying the preactivation gaussian tensors as raw little-
endian buffers:

  nre_data        {"version": "0.0.1", "model": "mogt"}
  precision       "half" | "single"
  mog_num         N
  mog_sph_degree  SH degree of the feature set
  mog_positions   [N,3]       float bytes
  mog_scales      [N,3]       log-scales (preactivation)
  mog_rotations   [N,4]       unnormalized quaternions (preactivation)
  mog_densities   [N]         opacity logits (preactivation)
  mog_features    [N,3+K*3]   SH albedo (dc) then specular (rest) coeffs,
                              rest flattened coefficient-major per channel
                              (the write_gaussian_ply f_rest order)

Consumes the `read_gaussian_ply` dict layout (models/gom.py) so any
trained Stage-4 / free-gaussian artifact exports directly. Host numpy +
msgpack: the port's copy of holoscene_tpu/export/gs_ingp.py, writing the
same bytes.
"""

from __future__ import annotations

import gzip

import msgpack
import numpy as np


def _sh_degree(n_rest_coeffs: int) -> int:
    # n_rest = (degree+1)^2 - 1 per channel
    return int(round(np.sqrt(n_rest_coeffs + 1))) - 1


def export_gaussians_ingp(out_path: str, g: dict,
                          force_half: bool = False) -> None:
    """g: read_gaussian_ply layout — means [N,3], features_dc [N,3],
    features_rest [N,K,3], opacity_logits [N], log_scales [N,3],
    quats [N,4]."""
    means = np.asarray(g["means"], np.float32)
    n = means.shape[0]
    rest = np.asarray(g["features_rest"], np.float32).reshape(n, -1, 3)
    dtype = np.float16 if force_half else np.float32

    def buf(a):
        return np.ascontiguousarray(a, dtype=dtype).tobytes()

    features = np.concatenate(
        [np.asarray(g["features_dc"], np.float32),
         rest.transpose(0, 2, 1).reshape(n, -1)], axis=1
    )  # [N, 3 + 3*K] channel-major rest, matching write_gaussian_ply order

    payload = {
        "nre_data": {"version": "0.0.1", "model": "mogt"},
        "precision": "half" if force_half else "single",
        "mog_num": int(n),
        "mog_sph_degree": _sh_degree(rest.shape[1]),
        "mog_positions": buf(means),
        "mog_scales": buf(np.asarray(g["log_scales"], np.float32)),
        "mog_rotations": buf(np.asarray(g["quats"], np.float32)),
        "mog_densities": buf(np.asarray(g["opacity_logits"], np.float32)),
        "mog_features": buf(features),
    }
    with gzip.open(out_path, "wb") as f:
        f.write(msgpack.packb(payload))


def read_gaussians_ingp(path: str) -> dict:
    """Round-trip reader returning the read_gaussian_ply dict layout."""
    with gzip.open(path, "rb") as f:
        d = msgpack.unpackb(f.read())
    assert d["nre_data"]["model"] == "mogt", "not a gaussian-mixture ingp"
    n = d["mog_num"]
    dt = np.float16 if d["precision"] == "half" else np.float32

    def arr(key, shape):
        return np.frombuffer(d[key], dtype=dt).astype(
            np.float32).reshape(shape)

    features = arr("mog_features", (n, -1))
    k = (features.shape[1] - 3) // 3
    return {
        "means": arr("mog_positions", (n, 3)),
        "log_scales": arr("mog_scales", (n, 3)),
        "quats": arr("mog_rotations", (n, 4)),
        "opacity_logits": arr("mog_densities", (n,)),
        "features_dc": features[:, :3],
        "features_rest": features[:, 3:].reshape(n, 3, k).transpose(0, 2, 1),
    }


def main(argv=None):
    """PLY -> INGP CLI (reference INGPExporter semantics).

    Usage: python -m holoscene_tpu_torch.export.gs_ingp input.ply
           [--output_file x.ingp] [--half]
    """
    import argparse

    from holoscene_tpu_torch.models.gom import read_gaussian_ply

    p = argparse.ArgumentParser()
    p.add_argument("input_file")
    p.add_argument("--output_file", default=None)
    p.add_argument("--half", action="store_true")
    args = p.parse_args(argv)
    out = args.output_file or args.input_file.rsplit(".", 1)[0] + ".ingp"
    export_gaussians_ingp(out, read_gaussian_ply(args.input_file),
                          force_half=args.half)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
