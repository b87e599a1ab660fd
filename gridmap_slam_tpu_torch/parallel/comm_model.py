"""Bytes-per-scan communication model of the port's distributed engines.

The port's counterpart of gridmap_slam_tpu/parallel/comm_model.py, which
has no JAX in it but is not imported (the JAX package's __init__ loads
jax).  `CollectiveRow` and `project_two_host` are kept unchanged
(tests/test_torch_ba.py pins them to the originals); `comm_table` is
re-derived for the collectives the port's engines call (parallel/mesh.py
records each call with its bytes, and the same test holds every row to
those records in a gloo run):

- the weight statistics are one pmax and two psums (the normalizer; Neff's
  sum and the weighted pose as one 4-vector), where the JAX engines psum
  Neff and the weighted pose apart and elect the best index by a second
  psum; the port gathers (score, pose, local index) in one all_gather;
- the resample's all_gather of (log-weight, pose) rows runs only on a 'p'
  axis of more than one rank (on one rank the resample gathers on the
  card); with it go a pmax of the new log-weights' maximum and, with
  recovery injection, a psum of their sum.  They run only on scans that
  resample, as in the JAX comm model (gridmap_slam_tpu/parallel/
  comm_model.py:50-55): inside the gate's body (parallel/shmap.
  finish_step), an IF node of the compiled step's CUDA graph and a host
  read of the gate in the eager step, so one table counts both forms;
- the halos are ppermutes (batch_isend_irecv) of raw log-odds, one field:
  K3 builds the field and the evidence mask from the same extended tile,
  where the JAX blur exchanges halos of both; a rank with two neighbours
  sends each halo both ways (the rows count that rank), an edge rank one;
- the sharded RBPF (GSPMD in the JAX package, no rows there) is listed:
  its halos and score psums are the tiled engine's times the local
  particles, with the half-resolution coarse stage's pooled halo, and its
  resample moves the maps (all_gather of every rank's tiles, on
  resampling scans only).

Layout rule (parallel/dcn.py): 'p' across hosts, 'm' inside a host, so
the rows that may cross hosts are the axis='p' rows.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import SlamConfig


@dataclasses.dataclass(frozen=True)
class CollectiveRow:
    """One collective's per-scan, per-device payload."""

    engine: str
    collective: str        # psum | all_gather | ppermute | pmax
    axis: str              # 'p' (DCN candidate) | 'm' (ICI)
    bytes_per_scan: int    # payload bytes moved per device per scan
    when: str              # 'every scan' | 'resampling scans only'
    what: str


ENGINES = ("shmap", "shmap_surface", "tiled", "surface_sharded", "sharded")
RESAMPLE = "resampling scans only"


def _weight_stat_rows(engine: str, cfg: SlamConfig, n_p: int,
                      p_loc: int, map_bytes: int) -> List[CollectiveRow]:
    """The collectives of parallel/shmap.finish_step, which every engine
    shares.  map_bytes: the bytes of a rank's maps that move with its
    particles on a resample (the sharded RBPF), else 0."""
    every, resample = "every scan", RESAMPLE
    rows = [
        CollectiveRow(engine, "pmax", "p", 4, every, "max log-weight"),
        CollectiveRow(engine, "psum", "p", 4, every, "weight normalizer"),
        CollectiveRow(engine, "psum", "p", 16, every,
                      "Neff's sum of squares and the weighted pose (3,)"),
        CollectiveRow(engine, "all_gather", "p", 4 * 5 * n_p, every,
                      "strongest particle: (score, pose, local index) a "
                      "rank"),
    ]
    if n_p > 1:
        rows += [
            CollectiveRow(engine, "all_gather", "p", 16 * p_loc * n_p,
                          resample, "systematic resampling: log-weight "
                          "(4 B) + pose (12 B) a particle"),
            CollectiveRow(engine, "pmax", "p", 4, resample,
                          "max of the resampled log-weights"),
        ]
        if map_bytes:
            rows.append(CollectiveRow(
                engine, "all_gather", "p", map_bytes * n_p, resample,
                "the maps' column tiles of every particle"))
        mc = cfg.matcher
        if mc.surface_reinject_slow > 0.0 and mc.surface_reinject_fast > 0.0:
            rows.append(CollectiveRow(engine, "psum", "p", 4, resample,
                                      "injected slots' mean log-weight"))
    return rows


def _center_rows(engine: str) -> List[CollectiveRow]:
    every = "every scan"
    return [CollectiveRow(engine, "pmax", "p", 4, every,
                          "previous cloud's max log-weight"),
            CollectiveRow(engine, "psum", "p", 4, every,
                          "previous cloud's normalizer"),
            CollectiveRow(engine, "psum", "p", 12, every,
                          "previous cloud's weighted mean (volume centre)")]


def _grids(cfg: SlamConfig):
    mc = cfg.matcher
    coarse = mc.coarse_nt * mc.coarse_nxy * mc.coarse_nxy
    fine = mc.fine_nt * mc.fine_nxy * mc.fine_nxy
    return [coarse] + [fine] * (1 + mc.extra_refine_stages)


def _tile_rows(engine: str, cfg: SlamConfig, n_m: int, p_loc: int,
               fields: int, pooled: bool) -> List[CollectiveRow]:
    """Halo ppermutes and score psums over 'm' of `fields` tiled fields
    (1 for the tiled engine, P_loc for the sharded RBPF)."""
    if n_m == 1:
        rows = []
    else:
        h, r = cfg.map.cells_y, cfg.map.likelihood_radius
        rows = [CollectiveRow(engine, "ppermute", "m", 4 * fields * h * r * 2,
                              "every scan", f"K3 halo: {r} columns of raw "
                              "log-odds, both ways"),
                CollectiveRow(engine, "ppermute", "m", 4 * fields * h * 2,
                              "every scan", "LL bilinear halo: 1 column, "
                              "both ways")]
        if pooled:
            rows.append(CollectiveRow(
                engine, "ppermute", "m", 4 * fields * -(-h // 2) * 2,
                "every scan", "half-resolution field's halo: 1 column, "
                "both ways"))
    for i, grid in enumerate(_grids(cfg)):
        rows.append(CollectiveRow(
            engine, "psum", "m", 4 * grid * p_loc, "every scan",
            f"matcher stage {i} partial scores: {grid} candidates x "
            f"{p_loc} local particles"))
    return rows


def comm_table(cfg: SlamConfig, n_p: int, n_m: int,
               engine: str) -> List[CollectiveRow]:
    """Per-scan collective payloads of one engine on a (p=n_p, m=n_m)
    mesh, one row a collective call of a scan (the sharded RBPF's rows are
    those of one block of particle_chunk particles times the blocks), of
    the eager and the compiled (jit=True) step alike.  engine in
    ENGINES."""
    if engine not in ENGINES:
        raise ValueError(engine)
    if cfg.num_particles % n_p:
        raise ValueError(f"{cfg.num_particles} particles over {n_p} ranks")
    p_loc = cfg.num_particles // n_p
    h, w = cfg.map.cells_y, cfg.map.cells_x
    mc = cfg.matcher
    map_bytes = 4 * p_loc * h * (w // n_m) if engine == "sharded" else 0
    rows = _weight_stat_rows(engine, cfg, n_p, p_loc, map_bytes)
    if engine in ("shmap_surface", "surface_sharded"):
        rows += _center_rows(engine)
    if engine == "tiled":
        rows += _tile_rows(engine, cfg, n_m, p_loc, 1, pooled=False)
    elif engine == "sharded":
        chunk = cfg.particle_chunk
        chunk = chunk if 0 < chunk < p_loc and p_loc % chunk == 0 else p_loc
        block = _tile_rows(engine, cfg, n_m, chunk, chunk,
                           pooled=mc.coarse_halfres)
        rows += block * (p_loc // chunk)
    elif engine == "surface_sharded":
        if mc.surface_crop_cells > 0:       # 0 = the whole map
            hc, wc = min(mc.surface_crop_cells, h), min(
                mc.surface_crop_cells, w)
        else:
            hc, wc = h, w
        r = cfg.map.likelihood_radius
        hce, wce = min(hc + 2 * r, h), min(wc + 2 * r, w)
        nt_loc = -(-mc.surface_nt // n_m)
        rows += [
            CollectiveRow(engine, "psum", "m", 4 * hce * wce, "every scan",
                          f"raw log-odds crop assembly: ({hce}, {wce}) incl. "
                          "blur halo"),
            CollectiveRow(engine, "all_gather", "m",
                          4 * nt_loc * n_m * hc * wc, "every scan",
                          f"likelihood volume: {nt_loc} bins a rank x {n_m} "
                          f"ranks x ({hc}, {wc})")]
    return rows


def project_two_host(cfg: SlamConfig, n_p: int, n_m: int, engine: str,
                     step_ms: float, resample_rate: float,
                     dcn_gbps: float = 25.0,
                     dcn_latency_us: float = 30.0) -> dict:
    """Projected 2-host efficiency: hosts split the 'p' axis, so only
    axis='p' payloads cross DCN (an all_gather moves ~half its payload
    across the host boundary; psums a tree hop — both bounded by the full
    payload, used here as the conservative bound).  `step_ms` is the
    measured single-host per-scan compute at the same per-device load;
    `resample_rate` the measured fraction of scans that resample.
    Default dcn_gbps/latency are conservative public v5p-class figures;
    the loopback 2-process proxy row in docs/scaling_cpu.md is the
    structural (not bandwidth) validation."""
    rows = comm_table(cfg, n_p, n_m, engine)
    dcn_rows = [r for r in rows if r.axis == "p"]
    every = sum(r.bytes_per_scan for r in dcn_rows
                if r.when == "every scan")
    resamp = sum(r.bytes_per_scan for r in dcn_rows
                 if r.when != "every scan")
    n_coll = len(dcn_rows)
    avg_bytes = every + resample_rate * resamp
    comm_ms = (avg_bytes / (dcn_gbps * 1e9) * 1e3
               + n_coll * dcn_latency_us * 1e-3)
    eff = step_ms / (step_ms + comm_ms)
    return {
        "engine": engine,
        "dcn_bytes_every_scan": every,
        "dcn_bytes_resampling_scan": resamp,
        "resample_rate": resample_rate,
        "dcn_avg_bytes_per_scan": int(avg_bytes),
        "assumed_dcn_gbps": dcn_gbps,
        "assumed_dcn_latency_us": dcn_latency_us,
        "step_ms": step_ms,
        "projected_comm_ms": round(comm_ms, 4),
        "projected_2host_efficiency": round(eff, 4),
        "meets_80pct_criterion": bool(eff >= 0.80),
    }
