"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, bound here with ``ctypes``.  The build runs at
first use, one ``nvcc`` process per source, all started together, into
``build/kernels/`` at the repository root (listed in ``.gitignore``); a
library is named by a hash of its sources and flags, so an edited source
never loads a stale build.

A ``Kernel`` counts its launches: ``launches`` moves only where the kernel
itself is launched, so a run can show that its path went through it.
Nothing here runs at import: this module is imported on machines without
a CUDA toolkit, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAXR = 8  # KOORD_MAXR in csrc/pair.cuh
MAX_SHAPE = 101  # KOORD_MAX_SHAPE in csrc/pair.cuh
# the NodeFit strategy ids of csrc/pair.cuh
STRATEGY_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}

# study builds: a source that includes another with a study's measurement
# compiled in (csrc/roundstudy.cu: schedule.cu's round loop with its phase
# split; csrc/scanstudy.cu: the scan's; csrc/scorestudy.cu: the score
# kernel's store floor and strip sweep; csrc/deschedstudy.cu: the round's
# split by grid barrier; csrc/bandstudy.cu: the band order's split by
# step; csrc/refreshstudy.cu: the warm refresh with its large parameter
# block only), built only when a study binds one of its entry points
STUDY = {"roundstudy": "schedule.cu", "scanstudy": "scan.cu", "scorestudy": "score.cu",
         "deschedstudy": "deschedule.cu", "bandstudy": "bandrank.cu",
         "refreshstudy": "schedule.cu"}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def sources(stem: str) -> list:
    """The files a library is built from: the shared headers, its source
    and, for a study build, the source it includes."""
    own = [CSRC / f"{stem}.cu"] + ([CSRC / STUDY[stem]] if stem in STUDY else [])
    return sorted(CSRC.glob("*.cuh")) + own


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    for src in sources(stem):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def build(stems=None) -> Dict[str, Path]:
    """Compile the libraries of ``stems`` (by default every ``csrc/*.cu``
    but the study builds) not yet built, in parallel; return stem ->
    library path.  The compiler's ``-Xptxas -v`` report lands in
    ``<library>.log``.  Raises when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if stems is None:
        stems = [src.stem for src in sorted(CSRC.glob("*.cu")) if src.stem not in STUDY]
    out = {stem: _lib_path(stem) for stem in stems}
    todo = {stem: path for stem, path in out.items() if not path.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for stem, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            tail = todo[stem].with_suffix(".log").read_text().splitlines()[-20:]
            failed.append(f"{stem}.cu:\n" + "\n".join(tail))
        else:
            os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return out


def _library(stem: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build([stem] if stem in STUDY else None)[stem]))
            lib.koord_strerror.argtypes = [ctypes.c_int]
            lib.koord_strerror.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib


class Kernel:
    """One C entry point of a ``csrc`` library, with its launch count."""

    def __init__(self, stem: str, symbol: str, argtypes: list):
        self.stem = stem
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = _library(self.stem)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the given stream; raise if the launch was refused."""
        rc = self._bind()(*args)
        if rc != 0:
            msg = _library(self.stem).koord_strerror(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: {msg} ({rc})")
        self.launches += 1


class HostFn:
    """A host C entry point of a ``csrc`` library (no launch, no count),
    bound at first use; returns what the C function returns."""

    def __init__(self, stem: str, symbol: str, argtypes: list):
        self.stem, self.symbol, self.argtypes = stem, symbol, argtypes
        self._fn = None

    def __call__(self, *args) -> int:
        if self._fn is None:
            fn = getattr(_library(self.stem), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

SCORE = Kernel("score", "koord_score", [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P])
# the schedule kernels' leading arguments: the pod, node and configuration
# tables, the LoadAware weights, valid, pod_ok, the salts, then the batch's
# placement-and-devices mask and scores ([N, P] queue order, 0 = absent)
_SCHED_HEAD = [_P] * 9
SCHEDULE_KEYS = Kernel(
    "schedule", "koord_sched_keys", _SCHED_HEAD + [_I, _I, _I, _L, _P, _P, _P, _I, _P],
)
# the round loop: ... TB, K, the grid G (``rounds_grid``), M, Mb, la_feas_T,
# the scratch (``rounds_scratch_words``), hosts, scores, rounds
SCHEDULE_ROUNDS = Kernel(
    "schedule", "koord_sched_rounds",
    _SCHED_HEAD + [_I, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
)
REFRESH_PARAM_WORDS = 7168  # kRefreshLarge: refresh plan words a launch's parameters carry
# the warm carry: the delta refresh (... TB, [the constraint table and
# block,] the dirty rows' int32 host index and its length, M, Mb,
# la_feas_T), and the round loop launched on copies of the carry (the same
# entry point as the cold rounds, counted apart)
SCHED_REFRESH = Kernel(
    "schedule", "koord_sched_refresh",
    _SCHED_HEAD + [_I, _I, _I, _L, _P, _I, _P, _P, _P, _I, _P],
)
SCHED_ROUNDS = Kernel("schedule", "koord_sched_rounds", SCHEDULE_ROUNDS.argtypes)
# the constrained instantiations (gang, quota, reservation): the same
# launches with a constraint pointer table and parameter block
SCHEDULE_KEYS_CON = Kernel(
    "schedule", "koord_sched_keys_con",
    _SCHED_HEAD + [_I, _I, _I, _L, _P, _P, _P, _P, _P, _I, _P],
)
SCHEDULE_ROUNDS_CON = Kernel(
    "schedule", "koord_sched_rounds_con",
    _SCHED_HEAD + [_I, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
)
SCHED_REFRESH_CON = Kernel(
    "schedule", "koord_sched_refresh_con",
    _SCHED_HEAD + [_I, _I, _I, _L, _P, _P, _P, _I, _P, _P, _P, _I, _P],
)
SCHED_ROUNDS_CON = Kernel("schedule", "koord_sched_rounds_con", SCHEDULE_ROUNDS_CON.argtypes)
# the int64-key matrix engine: the cold key build and the round loop over
# int64 key lanes, plain and constrained (the same arguments)
SCHEDULE_KEYS64 = Kernel("schedule", "koord_sched_keys64", SCHEDULE_KEYS.argtypes)
SCHEDULE_ROUNDS64 = Kernel("schedule", "koord_sched_rounds64", SCHEDULE_ROUNDS.argtypes)
SCHEDULE_KEYS64_CON = Kernel("schedule", "koord_sched_keys64_con", SCHEDULE_KEYS_CON.argtypes)
SCHEDULE_ROUNDS64_CON = Kernel("schedule", "koord_sched_rounds64_con",
                               SCHEDULE_ROUNDS_CON.argtypes)
# the greedy scan's step kernel (csrc/scan.cu), after the int64 key build,
# plain and constrained: the pair inputs, P, N, BS, TB, [the constraint
# table and block,] M, Mb and its transpose (updated in place), hosts, scores
SCAN = Kernel("scan", "koord_scan_steps",
              _SCHED_HEAD + [_I, _I, _I, _L, _P, _P, _P, _P, _P, _I, _P])
SCAN_CON = Kernel("scan", "koord_scan_steps_con",
                  _SCHED_HEAD + [_I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P])
# the device residency (csrc/dstate.cu)
# the buffer count, the descriptor ([n, 2] int64: destination, row bytes),
# the pinned staging, the device buffer and its capacity in bytes, D
DSTATE_SCATTER = Kernel("dstate", "koord_dstate_scatter", [_I, _P, _P, _P, _L, _I, _I, _P])
# the gate's bound descriptor (``GateStage``: the five inputs, N, the
# device), now, exp, the flags word, the [4, N] output, the stream
DSTATE_GATE = Kernel("dstate", "koord_dstate_gate", [_P, _D, _D, _I, _P, _P])
GATE_HAS_EXP, GATE_EXP_POS, GATE_FEXP = 1, 2, 4  # KOORD_GATE_* in csrc/dstate.cu
# the buffer count, the packed descriptor ([n, 6] int64), the rows
DSTATE_EXTEND = Kernel("dstate", "koord_dstate_extend", [_I, _P, _I, _I, _P])
DSTATE_MAX_ARRAYS = 32  # KOORD_DSTATE_MAX_ARRAYS in csrc/dstate.cu
# the placement-policy mask (csrc/placement.cu): the calling thread's last
# plan launched over the four policy tables, their widths, N, the carry
# scratch and the descriptor's device buffer (each or null), the output
PLACEMENT = Kernel("placement", "koord_placement",
                   [_P] * 4 + [_I] * 5 + [_P, _P, _P, _I, _P])
# ... and its host plan: the concatenated lists, M, the lists' entries and
# the tables' widths, the phases' shared memory, the [4] result
PLACEMENT_PLAN = HostFn("placement", "koord_placement_plan", [_P, _I, _P, _I, _P])
PLACEMENT_PARAM_WORDS = 7680  # kParamWords: descriptor words in a launch's parameters
# device feasibility and the deviceshare score (csrc/device.cu), each from
# a ``DeviceStage``'s descriptor (the four node rows' pointers, N, Gm, the
# device, the two aggregates' pointers): ``dev_feasible`` takes the host
# block of packed signatures, its copy on the card past ``DEV_SIG_CAP``
# signatures (else null), M, the output and the stream; ``ds_score`` the
# host block of requests, its copy past ``DS_REQ_CAP`` (else null), M, the
# weight, the output and the stream
DEV_FEASIBLE = Kernel("device", "koord_dev_feasible", [_P, _P, _P, _I, _P, _P])
DEV_SIG_CAP = 128  # kSigCap in csrc/device.cu: signatures a launch's parameters carry
DS_SCORE = Kernel("device", "koord_ds_score", [_P, _P, _P, _I, _L, _P, _P])
DS_REQ_CAP = 128  # kReqCap in csrc/device.cu: requests a launch's parameters carry
# the quota tree's runtime refresh (csrc/quota.cu): ``quota`` and the
# admission limit ``quota_limit`` (row 0 := 2**60) share one entry point:
# the eight per-group arrays and the total, the tree's plan and its words,
# L, runs, Q, R, the global tier's scratch (0: shared memory), the flags,
# the output
QUOTA = Kernel("quota", "koord_quota", [_P] * 9 + [_I] * 5 + [_P, _I, _I, _P, _I, _P])
QUOTA_LIMIT = Kernel("quota", "koord_quota", QUOTA.argtypes)
# the reservation plugin's scores (csrc/reservation.cu, one template):
# ``rsv_rscore`` (request, allocatable, allocated, P, Rv, Rf, the [P, Rv]
# output) and ``rsv_score`` (request, node, allocatable, allocated, rank,
# matched, P, Rv, Rf, N, the [P, Rv] rscore output or null, the [P, N]
# output)
RSV_RSCORE = Kernel("reservation", "koord_rsv_rscore", [_P] * 3 + [_I] * 3 + [_P, _I, _P])
RSV_SCORE = Kernel("reservation", "koord_rsv_score", [_P] * 6 + [_I] * 4 + [_P, _P, _I, _P])
RSV_MAX = 4096  # KOORD_RSV_MAX in csrc/reservation.cu: reservations a score launch takes
# the per-plugin scores of SCORE's breakdown and the LoadAware library
# entry point (csrc/breakdown.cu): the pod and node pointer tables, the
# configuration block, [the LoadAware weights,] P, N, the outputs
LA_SCORE = Kernel("breakdown", "koord_la_score", [_P, _P, _P, _P, _I, _I, _P, _I, _P])
NF_SCORE = Kernel("breakdown", "koord_nf_score", [_P, _P, _P, _I, _I, _P, _I, _P])
LA_SCORE_FILTER = Kernel("breakdown", "koord_la_score_filter",
                         [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P])
# the descheduler (csrc/deschedule.cu, csrc/bandrank.cu): one LowNodeLoad
# round (the input, output and parameter tables, the scratch; the
# parameters end with the main blocks, ``desched_grid``)
DESCHEDULE_ROUND = Kernel("deschedule", "koord_deschedule_round", [_P, _P, _P, _P, _I, _P])
# the band order: the packed descriptor (K, P, G, then each key column's
# pointer, element bytes and mode), the permutation, the scratch
POD_BAND_RANK = Kernel("bandrank", "koord_band_rank", [_P, _P, _P, _I, _P])
# the koordlet's NodeMetric aggregation (csrc/metricsagg.cu): values,
# valid, times, S, T, the four percentiles (float32), the [6, S] output
AGGREGATE_NODE_METRICS = Kernel("metricsagg", "koord_aggregate_node_metrics",
                                [_P, _P, _P, _I, _I, _P, _P, _I, _P])
# SCORE over one mesh device's node block: the score kernel over a column
# block (csrc/score.cu ``koord_shard_score``): the pair tables, the extra
# scores, P, N, the block's first column and width, the outputs
SHARD_SCORE_MAP = Kernel("score", "koord_shard_score", [_P] * 6 + [_I] * 4 + [_P, _P, _I, _P])
KERNELS = {
    "score": SCORE, "schedule_keys": SCHEDULE_KEYS, "schedule_rounds": SCHEDULE_ROUNDS,
    "sched_refresh": SCHED_REFRESH, "sched_rounds": SCHED_ROUNDS,
    "dstate_scatter": DSTATE_SCATTER, "dstate_gate": DSTATE_GATE,
    "schedule_keys_con": SCHEDULE_KEYS_CON, "schedule_rounds_con": SCHEDULE_ROUNDS_CON,
    "sched_refresh_con": SCHED_REFRESH_CON, "sched_rounds_con": SCHED_ROUNDS_CON,
    "quota": QUOTA, "quota_limit": QUOTA_LIMIT, "rsv_rscore": RSV_RSCORE,
    "rsv_score": RSV_SCORE, "placement": PLACEMENT, "dev_feasible": DEV_FEASIBLE,
    "ds_score": DS_SCORE, "dstate_extend": DSTATE_EXTEND, "scan": SCAN, "scan_con": SCAN_CON,
    "schedule_keys64": SCHEDULE_KEYS64, "schedule_rounds64": SCHEDULE_ROUNDS64,
    "schedule_keys64_con": SCHEDULE_KEYS64_CON, "schedule_rounds64_con": SCHEDULE_ROUNDS64_CON,
    "la_score": LA_SCORE, "nf_score": NF_SCORE, "loadaware_score_and_filter": LA_SCORE_FILTER,
    "deschedule_round": DESCHEDULE_ROUND, "pod_band_rank": POD_BAND_RANK,
    "aggregate_node_metrics": AGGREGATE_NODE_METRICS, "shard_score_map": SHARD_SCORE_MAP,
}


def scratch_bytes(stem: str, symbol: str, *dims: int) -> int:
    """The scratch a ``csrc`` entry point needs for the given sizes, from
    the library's own size function (host code; nothing is launched)."""
    fn = getattr(_library(stem), symbol)
    fn.argtypes = [ctypes.c_longlong] * len(dims)
    fn.restype = ctypes.c_longlong
    return int(fn(*dims))

# the largest dynamic shared memory one block may take on Hopper
MAX_SMEM = 232_448


ROUND_THREADS = 1024  # kRoundThreads in csrc/schedule.cu: the round loop's block
# kStageBytes: a chunk of 16 touched node rows staged for the rescoring
ROUND_STAGE_BYTES = 16 * (8 * (7 * MAXR + 2) + 1 + 1 + 4)
ROUND_RECORD_WORDS = 64  # kRecWords: a round record (a touched node row)
# the Mb words one block of the round loop sweeps a round at least, before
# another block is worth its arrival
ROUND_SWEEP_WORDS = 4096


def _round_temps(P: int, K: int, key_bytes: int) -> int:
    """The round loop's per-round temporaries (block 0's pod and slot
    arrays, overlaid by each block's [ROUND_THREADS] sweep partials and its
    staged rows)."""
    return max(P * (key_bytes + 2 * 4 + 2) + K * 2 * 4, ROUND_THREADS * key_bytes,
               ROUND_STAGE_BYTES)


def rounds_smem(P: int, K: int, key_bytes: int = 4) -> int:
    """Dynamic shared memory of the round-loop kernel over key lanes of
    ``key_bytes`` (mirrors ``rounds_smem`` in csrc/schedule.cu): the
    temporaries, then a committed flag per pod."""
    return _round_temps(P, K, key_bytes) + P


def rounds_smem_con(P: int, K: int, ancestor_depth: int, has_quota: bool,
                    key_bytes: int = 4) -> int:
    """Dynamic shared memory of the constrained instantiation (mirrors
    ``rounds_smem_con`` in csrc/schedule.cu): with quota each pod's chain
    of group rows."""
    base = (_round_temps(P, K, key_bytes) + P + 15) & ~15
    return base + (P * ancestor_depth * 4 if has_quota else 0)


def rounds_grid(P: int, N: int, block_size: int, K: int, sms: int) -> int:
    """Blocks of the round loop's cooperative launch: enough that each
    sweeps about ``ROUND_SWEEP_WORDS`` words of Mb a round and that the
    rescoring's K x P pairs give each thread at most one, but never more
    than one a SM or one a pod; then trimmed so that the last block owns
    pods too (block g owns pods [g * ppb, (g+1) * ppb), ppb = ceil(P/G))."""
    NB = -(-N // block_size)
    want = max(-(-P * NB // ROUND_SWEEP_WORDS), -(-K * P // ROUND_THREADS), 1)
    G = max(1, min(want, sms, P))
    return -(-P // -(-P // G))


def rounds_scratch_words(P: int, K: int, N: int) -> int:
    """int64 words of the round loop's scratch (mirrors the layout in
    csrc/schedule.cu): the pods' maxima, K round records (a touched node
    row each), then int32 words for the arrival count, the released round,
    the frontier, the record count and node_first.  The kernel's launch
    zeroes the first two int32 words and writes the rest before reading."""
    return P + K * ROUND_RECORD_WORDS + (4 + N + 1) // 2


DESCHED_THREADS = 1024  # kThreads in csrc/deschedule.cu: a block of the round's launch
DESCHED_MAX_GRID = 132  # kMaxG: main blocks at most


def desched_side_blocks(R: int, use_deviation: bool) -> int:
    """The round's side blocks beside its main ones (mirrors
    ``koord_deschedule_round``): one a percentile's order statistic (two
    each of p50, p90 and p99 of R resources), and in deviation mode one for
    the thresholds' mean."""
    return 6 * R + (1 if use_deviation else 0)


def desched_grid(N: int, Pc: int, R: int, use_deviation: bool, sms: int) -> int:
    """Main blocks of the round's cooperative launch: one a
    ``DESCHED_THREADS`` positions of the larger axis (nodes or
    candidates), so a thread takes one node and one candidate where the
    card has the blocks, at most ``DESCHED_MAX_GRID`` and as many as the
    card's SMs leave beside the side blocks (a block an SM), at least 1."""
    want = -(-max(N, Pc) // DESCHED_THREADS)
    return max(1, min(want, DESCHED_MAX_GRID, sms - desched_side_blocks(R, use_deviation)))


BAND_THREADS = 1024  # kThreads in csrc/bandrank.cu
BAND_SMALL_MAX = 8192  # kSmallMax: pods one block sorts in shared memory
BAND_MAX_GRID = 132  # kMaxG


def band_grid(P: int, sms: int) -> int:
    """Blocks of ``pod_band_rank``'s launch: one up to ``BAND_SMALL_MAX``
    pods (shared memory), else a cooperative launch of one block a
    ``BAND_THREADS`` pods, at most one an SM and ``BAND_MAX_GRID``."""
    if P <= BAND_SMALL_MAX:
        return 1
    return max(1, min(-(-P // BAND_THREADS), sms, BAND_MAX_GRID))


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, read with one C call
    (a ``torch.cuda.Stream`` object costs a few µs of every launch's host
    time)."""
    return torch._C._cuda_getCurrentRawStream(device_index(device))


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return _sm_count(device_index(device))


CFG_LEN = 3 + 3 * MAXR + 2 + 2 * MAX_SHAPE  # KOORD_CFG_LEN in csrc/pair.cuh


@functools.lru_cache(maxsize=64)
def cfg_array(R: int, Rf: int, Rs: int, nf_static) -> ctypes.Array:
    """The kernels' host configuration block, laid out as ``koord_cfg`` in
    csrc/pair.cuh reads it: (R, Rf, Rs), then the NodeFit resource weights,
    ``always_check`` and ``scalar_bypass``, each padded to ``MAXR``; then
    the strategy id, the number of RequestedToCapacityRatio shape points
    and their utilizations and (0..100-scaled) scores, each padded to
    ``MAX_SHAPE``.  It depends only on static config, so it is built once
    per configuration and never read back from the card.  The blocks are
    read-only.  Raises ``ValueError`` on an unknown strategy or a shape the
    reference would not build (RequestedToCapacityRatio needs 1 to 101
    points with strictly increasing utilizations in 0..100)."""

    def pad(vals, width=MAXR):
        vals = [int(v) for v in vals]
        return vals + [0] * (width - len(vals))

    strategy = STRATEGY_IDS.get(nf_static.strategy)
    if strategy is None:
        raise ValueError(f"unknown NodeFit scoring strategy {nf_static.strategy!r}")
    shape = tuple(nf_static.shape) if nf_static.strategy == "RequestedToCapacityRatio" else ()
    if nf_static.strategy == "RequestedToCapacityRatio":
        us = [int(u) for u, _ in shape]
        if not 1 <= len(shape) <= MAX_SHAPE or us != sorted(set(us)) or not (
                0 <= us[0] and us[-1] <= 100):
            raise ValueError(f"RequestedToCapacityRatio shape {shape}: 1 to {MAX_SHAPE} points "
                             "with strictly increasing utilizations in 0..100")
    return (ctypes.c_longlong * CFG_LEN)(
        R, Rf, Rs, *pad(nf_static.weights), *pad(nf_static.always_check),
        *pad(nf_static.scalar_bypass), strategy, len(shape),
        *pad([u for u, _ in shape], MAX_SHAPE), *pad([s for _, s in shape], MAX_SHAPE),
    )


@functools.lru_cache(maxsize=MAXR + 1)
def loadaware_cfg(R: int) -> ctypes.Array:
    """The LoadAware-only kernels' configuration block (``la_score``,
    ``loadaware_score_and_filter``): ``cfg_array``'s layout with (R, 0, 0)
    and a NodeFit half of zeros.  It depends on R alone, so it is built once
    per R, shared by every call and never written (the strip kernel reads
    only R from it)."""
    return (ctypes.c_longlong * CFG_LEN)(R, 0, 0)


def require_least_allocated(nf_static, what: str) -> None:
    """The round loops' precondition (the cold and warm rounds and the warm
    refresh; the key build takes every strategy): the resolved engine is
    exact only under LeastAllocated, whose scores fall as a node fills (the
    JAX package's monotonicity precondition, core/resolved.py:286-292);
    other strategies take the scan."""
    if nf_static.strategy != "LeastAllocated":
        raise ValueError(f"{what} requires the LeastAllocated strategy (monotonicity "
                         f"precondition), got {nf_static.strategy}; it takes the scan")


class PairArgs(NamedTuple):
    """ctypes views of the pair-function inputs; ``keep`` holds the tensors
    the pointers point into for as long as the launch may read them."""

    pods: int
    nodes: int
    cfg: int
    la_w: int
    valid: int
    keep: tuple


def _ptr_table(tensors) -> array.array:
    """A pointer table for a launch: the tensors' 64-bit addresses in a
    buffer whose own address is ``table.buffer_info()[0]``, kept alive by
    the caller until the launch has read it; a ``None`` entry (a half the
    kernel does not read) is a null pointer.  (An ``array.array`` fills in
    about a third of the host time of a ctypes array of ``c_void_p``.)"""
    return array.array("Q", [0 if t is None else t.data_ptr() for t in tensors])


def _checked(t: torch.Tensor, dtype: torch.dtype, shape: tuple, device, what: str):
    if t.dtype is not dtype or t.shape != shape or t.device != device:
        raise ValueError(
            f"{what}: expected {dtype} {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


# The pointer tables in csrc/pair.cuh's order (KOORD_NUM_POD_PTRS = 4 + 3,
# KOORD_NUM_NODE_PTRS = 11 + 6): the LoadAware half, then the NodeFit half.
_LA_POD_PTRS, _LA_NODE_PTRS = 4, 11
_NF_POD_PTRS, _NF_NODE_PTRS = 3, 6


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    return t.device


def _la_tables(la_pods, la_nodes, P: int, N: int, dev):
    """The LoadAware halves of the pod and node pointer tables, checked
    against P pods and N node columns on ``dev``."""
    R = la_pods.est.shape[1]
    if R > MAXR:
        raise ValueError(f"resource axis {R} exceeds {MAXR}")
    i64, b = torch.int64, torch.bool
    pods = (
        _checked(la_pods.est, i64, (P, R), dev, "est"),
        _checked(la_pods.is_prod_score, b, (P,), dev, "is_prod_score"),
        _checked(la_pods.is_prod_class, b, (P,), dev, "is_prod_class"),
        _checked(la_pods.is_daemonset, b, (P,), dev, "is_daemonset"),
    )
    nodes = (
        _checked(la_nodes.alloc, i64, (N, R), dev, "la alloc"),
        _checked(la_nodes.base_nonprod, i64, (N, R), dev, "base_nonprod"),
        _checked(la_nodes.base_prod, i64, (N, R), dev, "base_prod"),
        _checked(la_nodes.score_valid, b, (N,), dev, "score_valid"),
        _checked(la_nodes.filter_usage, i64, (N, R), dev, "filter_usage"),
        _checked(la_nodes.filter_active, b, (N,), dev, "filter_active"),
        _checked(la_nodes.thresholds, i64, (N, R), dev, "thresholds"),
        _checked(la_nodes.prod_usage, i64, (N, R), dev, "prod_usage"),
        _checked(la_nodes.prod_filter_active, b, (N,), dev, "prod_filter_active"),
        _checked(la_nodes.prod_thresholds, i64, (N, R), dev, "prod_thresholds"),
        _checked(la_nodes.has_prod_thresholds, b, (N,), dev, "has_prod_thresholds"),
    )
    return pods, nodes


def _nf_tables(nf_pods, nf_nodes, P: int, N: int, dev):
    """The NodeFit halves of the pod and node pointer tables, checked
    against P pods and N node columns on ``dev``."""
    Rf, Rs = nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    if max(Rf, Rs) > MAXR:
        raise ValueError(f"resource axes ({Rf}, {Rs}) exceed {MAXR}")
    i64, b = torch.int64, torch.bool
    pods = (
        _checked(nf_pods.req, i64, (P, Rf), dev, "req"),
        _checked(nf_pods.req_score, i64, (P, Rs), dev, "req_score"),
        _checked(nf_pods.has_any_request, b, (P,), dev, "has_any_request"),
    )
    nodes = (
        _checked(nf_nodes.alloc, i64, (N, Rf), dev, "nf alloc"),
        _checked(nf_nodes.requested, i64, (N, Rf), dev, "requested"),
        _checked(nf_nodes.num_pods, i64, (N,), dev, "num_pods"),
        _checked(nf_nodes.allowed_pods, i64, (N,), dev, "allowed_pods"),
        _checked(nf_nodes.alloc_score, i64, (N, Rs), dev, "alloc_score"),
        _checked(nf_nodes.req_score, i64, (N, Rs), dev, "node req_score"),
    )
    return pods, nodes


def _pair_args(pods, nodes, cfg, la_w=None, valid=None) -> PairArgs:
    pod_tab, node_tab = _ptr_table(pods), _ptr_table(nodes)
    return PairArgs(
        pods=pod_tab.buffer_info()[0],
        nodes=node_tab.buffer_info()[0],
        cfg=ctypes.addressof(cfg),
        la_w=0 if la_w is None else la_w.data_ptr(),
        valid=0 if valid is None else valid.data_ptr(),
        keep=(pods, nodes, la_w, valid, pod_tab, node_tab, cfg),
    )


def pair_args(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static,
              valid: torch.Tensor) -> PairArgs:
    """Validate the inputs of the pair function (``csrc/pair.cuh``) on one
    CUDA device and lay them out for a launch, reading nothing back from
    the card.  Raises on what the kernels do not take: axes wider than
    ``MAXR``, wrong dtypes or shapes, a bad NodeFit configuration.
    The LoadAware weights must sum to > 0, as the reference requires
    (the Engine checks it once, on the host)."""
    dev = _cuda_device(valid)
    P, R = la_pods.est.shape
    N = valid.shape[0]
    la_p, la_n = _la_tables(la_pods, la_nodes, P, N, dev)
    nf_p, nf_n = _nf_tables(nf_pods, nf_nodes, P, N, dev)
    cfg = cfg_array(R, nf_pods.req.shape[1], nf_pods.req_score.shape[1], nf_static)
    return _pair_args(la_p + nf_p, la_n + nf_n, cfg,
                      la_w=_checked(la_weights, torch.int64, (R,), dev, "LoadAware weights"),
                      valid=_checked(valid, torch.bool, (N,), dev, "valid"))


# the node table's entries the round loops commit into (base_nonprod,
# base_prod, requested, num_pods, the NodeFit score's requested)
_MUTABLE_NODE_PTRS = (1, 2, 12, 13, 16)


def with_private_nodes(args: PairArgs) -> PairArgs:
    """``args`` (``pair_args``) with the round loop's private copies of the
    node state it commits into, cloned from the checked tensors."""
    pods, nodes, la_w, valid, _, _, cfg = args.keep
    nodes = tuple(t.clone() if i in _MUTABLE_NODE_PTRS else t for i, t in enumerate(nodes))
    return _pair_args(pods, nodes, cfg, la_w=la_w, valid=valid)


_GRID_Y_MAX = 65_535  # the pod axis rides the grid's y dimension


def loadaware_args(la_pods, la_nodes, la_weights) -> PairArgs:
    """Validate the LoadAware inputs on one CUDA device and lay them out
    for the ``breakdown.cu`` strip kernel (``la_score``,
    ``loadaware_score_and_filter``); the NodeFit entries of the pointer
    tables are null and the configuration block is ``loadaware_cfg(R)``.
    The weights must sum to > 0, as the reference requires (the caller's
    contract; the kernel divides by their sum)."""
    dev = _cuda_device(la_pods.est)
    P, R = la_pods.est.shape
    if P > _GRID_Y_MAX:
        raise ValueError(f"LoadAware: {P} pods exceed the launch's {_GRID_Y_MAX}")
    pods, nodes = _la_tables(la_pods, la_nodes, P, la_nodes.alloc.shape[0], dev)
    return _pair_args(pods + (None,) * _NF_POD_PTRS, nodes + (None,) * _NF_NODE_PTRS,
                      loadaware_cfg(R),
                      la_w=_checked(la_weights, torch.int64, (R,), dev, "LoadAware weights"))


def nodefit_args(nf_pods, nf_nodes, nf_static) -> PairArgs:
    """Validate the NodeFit inputs on one CUDA device and lay them out for
    the ``breakdown.cu`` NodeFit strip (``nf_score``, every strategy; the
    LoadAware entries of the pointer tables are null and the configuration
    block is ``cfg_array``'s of (0, 0, Rs) and the static, one per (Rs,
    static), which is all the strip reads).  Raises on a bad NodeFit
    configuration."""
    dev = _cuda_device(nf_pods.req)
    P = nf_pods.req.shape[0]
    if P > _GRID_Y_MAX:
        raise ValueError(f"NodeFit: {P} pods exceed the launch's {_GRID_Y_MAX}")
    pods, nodes = _nf_tables(nf_pods, nf_nodes, P, nf_nodes.alloc.shape[0], dev)
    cfg = cfg_array(0, 0, nf_pods.req_score.shape[1], nf_static)
    return _pair_args((None,) * _LA_POD_PTRS + pods, (None,) * _LA_NODE_PTRS + nodes, cfg)
