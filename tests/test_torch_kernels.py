"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked ``cuda`` need an NVIDIA card and skip without one.  They run
``chip_smoke.py``'s checks at small shapes: every output is an integer,
compared exactly (tolerance 0).  This file imports nothing of JAX, so on a
machine with a card it runs as

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kernels.py

The unmarked tests check, on any machine, the host side the kernels share:
the configuration block's layout and the refusals before any launch.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
from koordinator_tpu_torch.core import resolved
from koordinator_tpu_torch.core.nodefit import NodeFitStatic
from koordinator_tpu_torch.service import state as sm
from koordinator_tpu_torch.utils.fixtures import random_cluster

SCALARS = (BATCH_CPU, BATCH_MEMORY)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda:0")


def _inputs(device, num_nodes, num_pods, seed=3):
    pods, nodes = random_cluster(seed, num_nodes=num_nodes, num_pods=num_pods)
    return chip_smoke.build_inputs(pods, nodes, device, SCALARS)


COLD = ("score", "schedule_keys", "schedule_rounds")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods,cap", [
    (300, 50, 1), (300, 50, 16), (300, 50, 100), (1000, 200, 16),
    (300, 1500, 16),  # 2,048 pod rows: each of the 1,024 threads owns two
])
def test_kernels_equal_plain(card, num_nodes, num_pods, cap):
    before = {k: cuda.KERNELS[k].launches for k in COLD}
    chip_smoke.check_kernels(_inputs(card, num_nodes, num_pods), cap, timed=False)
    assert all(cuda.KERNELS[k].launches == before[k] + 1 for k in COLD)


@pytest.mark.cuda
def test_kernels_equal_plain_ragged(card):
    """A node axis that is not a multiple of the block size, a pod axis
    that is not a power of two, a shuffled queue order."""
    chip_smoke.check_kernels(chip_smoke.ragged(_inputs(card, 300, 50), 300, 50), 16, timed=False)


WARM = ("sched_refresh", "sched_rounds", "dstate_scatter", "dstate_gate")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods,dirty,cap", [
    (300, 50, (16, 128), 16), (300, 50, (16,), 100), (1000, 200, (16, 128, 1024), 16),
    (2000, 1000, (16, 128), 16),  # the warm rounds over a grid of many blocks
])
def test_warm_kernels_equal_plain(card, num_nodes, num_pods, dirty, cap):
    """``sched_refresh`` (also against a cold key build), ``sched_rounds``
    (leaving its carry bit-identical), ``dstate_scatter`` with duplicate
    padded indices and ``dstate_gate`` at NaN and boundary times."""
    before = {k: cuda.KERNELS[k].launches for k in WARM}
    chip_smoke.check_warm_kernels(_inputs(card, num_nodes, num_pods), dirty, timed=False,
                                  commit_cap=cap)
    assert all(cuda.KERNELS[k].launches > before[k] for k in WARM)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(chip_smoke.ROUND_CASES))
def test_round_loop_cases(card, case):
    """The cooperative round loop against its plain version (hosts,
    scores, rounds and the updated M and Mb, exactly) where its grid's
    reckoning has edges: a last block owning fewer pods, a single pod and
    block, K = P, both key lanes, the quota upper bound, the extra
    channel."""
    kw = chip_smoke.ROUND_CASES[case][2]
    name = {True: "schedule_rounds64", False: "schedule_rounds"}[kw.get("wide", False)]
    name += "_con" if kw.get("con") else ""
    before = cuda.KERNELS[name].launches
    rec = chip_smoke.check_round_case(_inputs(card, 2000, 1000), case)
    assert cuda.KERNELS[name].launches == before + 1 and rec["grid"] >= 1


@pytest.mark.cuda
def test_round_loop_one_node_every_round(card):
    """Every pod prefers one node, so each round commits one pod on it and
    every block rescores the row the serial middle rewrote on another SM
    just before: a stale L1 line would show as a wrong key."""
    rec = chip_smoke.check_round_hot_node(_inputs(card, 2000, 300))
    assert rec["grid"] > 1


@pytest.mark.cuda
def test_extend_cases_equal_plain(card):
    """``dstate_extend`` with 32 buffers, ragged row widths and zero rows
    against its plain version and ``F.pad``, the sources unchanged."""
    before = cuda.KERNELS["dstate_extend"].launches
    chip_smoke.check_extend_cases(card)
    assert cuda.KERNELS["dstate_extend"].launches == before + 2  # zero rows launch nothing


def test_round_grid_reckoning():
    """The round loop's grid: one block a SM at most, never more blocks
    than pods, every block owning pods, more blocks for more sweeping or
    rescoring; the one-pod probe takes few blocks."""
    assert cuda.rounds_grid(1024, 16384, 16, 16, 132) == 128
    assert cuda.rounds_grid(1024, 16384, 64, 64, 132) == 64
    assert cuda.rounds_grid(16, 16384, 16, 16, 132) == 4
    assert cuda.rounds_grid(1, 16384, 16, 1, 132) == 1
    assert cuda.rounds_grid(64, 512, 16, 16, 132) == 1
    rng = np.random.default_rng(5)
    for _ in range(500):
        P, N = int(rng.integers(1, 20000)), int(rng.integers(1, 200000))
        BS, K = int(rng.choice([1, 16, 64])), int(rng.integers(1, 200))
        sms = int(rng.integers(1, 140))
        G = cuda.rounds_grid(P, N, BS, min(K, P), sms)
        ppb = -(-P // G)
        assert 1 <= G <= min(sms, P) and (G - 1) * ppb < P <= G * ppb
        assert G == cuda.rounds_grid(P, N, BS, min(K, P), sms)


def test_round_scratch_and_shared_memory():
    """The round loop's scratch holds the pods' maxima, the round records
    and the int32 words; its shared memory admits the
    largest P the single-block kernel admitted (the temporaries overlay the
    sweep's partials and the staged rows), in both key lanes, plain and
    constrained."""
    words = 1024 + 16 * 64 + (4 + 16384 + 1) // 2
    assert cuda.rounds_scratch_words(1024, 16, 16384) == words
    assert cuda.rounds_scratch_words(1, 1, 1) == 1 + 64 + 3

    def largest(fn):
        lo, hi = 1, 1 << 16
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fn(mid) <= cuda.MAX_SMEM else (lo, mid - 1)
        return lo

    for kb in (4, 8):
        old = largest(lambda P: P * (kb + 2 * 4 + 3) + 16 * 9)
        assert largest(lambda P: cuda.rounds_smem(P, 16, kb)) >= old
        old_con = largest(lambda P: ((P * (kb + 2 * 4 + 4) + 16 * 9 + 15) & ~15) + P * 8 * 4)
        assert largest(lambda P: cuda.rounds_smem_con(P, 16, 8, True, kb)) >= old_con
        # small P: the sweep's [1,024] partials or a staged chunk set the floor
        assert cuda.rounds_smem(16, 16, kb) == max(cuda.ROUND_THREADS * kb,
                                                   cuda.ROUND_STAGE_BYTES) + 16
    assert cuda.rounds_smem_con(16, 16, 8, False) % 16 == 0


@pytest.mark.cuda
def test_round_study_build_equals_plain(card):
    """The study build (csrc/roundstudy.cu) launches the same round loop:
    equal to the plain version, with block 0's phase split read back and
    zeroed for the next launch."""
    x = _inputs(card, 300, 50)
    rec = chip_smoke.round_case(x, 16, 16, "study build", study=True)
    assert sum(rec["split_cycles"][0]) > 0
    assert chip_smoke.round_split(card) == [[0] * 8] * 3


def _fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc that writes an empty library, and a build
    directory under ``tmp_path``."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(fake))


def test_build_leaves_out_the_study_builds(tmp_path, monkeypatch):
    """``cuda.build()`` compiles every library the paths launch and no
    study build; a study build is compiled when named, and its library's
    name follows the source it includes."""
    _fake_nvcc(tmp_path, monkeypatch)
    libs = cuda.build()
    assert set(libs) == {src.stem for src in cuda.CSRC.glob("*.cu")} - set(cuda.STUDY)
    assert "schedule" in libs and all(path.exists() for path in libs.values())
    assert not any(path.name.startswith("libroundstudy") for path in cuda.BUILD_DIR.iterdir())
    study = cuda.build(["roundstudy"])
    assert list(study) == ["roundstudy"] and study["roundstudy"].exists()
    assert cuda.CSRC / "schedule.cu" in cuda.sources("roundstudy")
    assert cuda.CSRC / "schedule.cu" not in cuda.sources("score")
    # an edit of the included source renames the study build, not another
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in cuda.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda, "CSRC", csrc)
    before = {stem: cuda._lib_path(stem) for stem in ("roundstudy", "schedule", "score")}
    with open(csrc / "schedule.cu", "a") as f:
        f.write("// edited\n")
    after = {stem: cuda._lib_path(stem) for stem in before}
    assert after["roundstudy"] != before["roundstudy"]
    assert after["schedule"] != before["schedule"] and after["score"] == before["score"]


def test_round_cases_run_on_cpu_tensors():
    """``chip_smoke``'s round-loop cases on CPU tensors, where the wrapper
    takes its plain version: the comparison logic (M and Mb included), the
    one-node feed, the four knob settings and the probe, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    x = _inputs(torch.device("cpu"), 300, 50)
    for P, cap, kw in chip_smoke.ROUND_CASES.values():
        chip_smoke.round_case(chip_smoke.ragged(x, 299, min(P, 50)), 16, min(cap, 100), "", **kw)
    hot, j = chip_smoke.hot_node(chip_smoke.ragged(x, 299, 50))
    rec = chip_smoke.round_case(hot, 16, 16, "one node every round")
    assert int((rec["outputs"][0] == j).sum()) >= 40 and rec["grid"] is None
    chip_smoke.check_round_loop(x, timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_extend_descriptor():
    """``dstate_extend``'s packed host descriptor: six int64 words a
    buffer in csrc/dstate.cu's order (source, destination, old and new
    columns, element size, fill), bool fills as 0 and 1."""
    desc = sm.extend_desc([4096, 8192], [65536, 65792], [3, 5], [5, 21], [8, 1], [-1, True])
    assert list(desc) == [4096, 65536, 3, 5, 8, -1, 8192, 65792, 5, 21, 1, 1]
    assert list(sm.extend_desc([1], [2], [0], [0], [4], [False])) == [1, 2, 0, 0, 4, 0]
    one = sm.extend_desc(*[[7] * 32] * 6)
    assert len(one) == 6 * 32 and set(one) == {7}


def test_extend_cases_run_on_cpu_tensors():
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_extend_cases(torch.device("cpu"))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_cfg_block_layout():
    static = NodeFitStatic(always_check=(True, True, True, False, False),
                           scalar_bypass=(False, True), weights=(3, 5))
    block = cuda.cfg_array(2, 5, 2, static)
    cfg = list(block)
    M, S = cuda.MAXR, cuda.MAX_SHAPE
    assert len(cfg) == 3 + 3 * M + 2 + 2 * S
    assert cfg[:3] == [2, 5, 2]
    assert cfg[3:3 + M] == [3, 5] + [0] * (M - 2)
    assert cfg[3 + M:3 + 2 * M] == [1, 1, 1, 0, 0] + [0] * (M - 5)
    assert cfg[3 + 2 * M:3 + 3 * M] == [0, 1] + [0] * (M - 2)
    # LeastAllocated: strategy 0, no shape points
    assert cfg[3 + 3 * M:] == [0, 0] + [0] * (2 * S)
    # built once per configuration: the launches read no weights back
    assert cuda.cfg_array(2, 5, 2, static) is block
    most = NodeFitStatic(**dict(static.__dict__, strategy="MostAllocated", shape=((0, 0),)))
    assert list(cuda.cfg_array(2, 5, 2, most))[3 + 3 * M:] == [1, 0] + [0] * (2 * S)
    shape = ((0, 20), (40, 100), (70, 30), (100, 60))
    rtc = NodeFitStatic(**dict(static.__dict__, strategy="RequestedToCapacityRatio", shape=shape))
    tail = list(cuda.cfg_array(2, 5, 2, rtc))[3 + 3 * M:]
    assert tail[:2] == [2, 4]
    assert tail[2:2 + S] == [0, 40, 70, 100] + [0] * (S - 4)
    assert tail[2 + S:] == [20, 100, 30, 60] + [0] * (S - 4)
    for bad in ((), ((0, 0), (0, 10)), ((50, 0), (20, 10)), ((0, 0), (101, 10))):
        with pytest.raises(ValueError, match="shape"):
            cuda.cfg_array(2, 5, 2, NodeFitStatic(**dict(rtc.__dict__, shape=bad)))


def test_kernels_refuse_before_launch():
    """``pair_args`` takes every strategy (and only CUDA tensors); the key
    build takes every strategy too (the scan builds its keys with it), and
    on CPU tensors equals ``build_keys_plain``; the round-loop wrappers
    (round loop, refresh, warm rounds) raise ``ValueError`` off
    LeastAllocated, on any device, before any launch."""
    x = _inputs(torch.device("cpu"), 40, 10)
    args = (x["la_pods"], x["la_nodes"], x["weights"], x["nf_pods"], x["nf_nodes"])
    most = NodeFitStatic(**dict(x["static"].__dict__, strategy="MostAllocated"))
    rtc = NodeFitStatic(**dict(x["static"].__dict__, strategy="RequestedToCapacityRatio",
                               shape=((0, 0), (100, 100))))
    for static in (x["static"], most, rtc):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda.pair_args(*args, static, x["valid"])
    carry, q_la, rest, N = _queue_inputs()
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    for static in (most, rtc):
        off = list(rest)
        off[4] = static
        q_extra = off[6][:, None] & off[5][None, :]
        for kdt, wide in ((torch.int32, False), (torch.int64, True)):
            want = resolved.build_keys_plain(q_la, off[0], off[1], off[2], off[3], static,
                                             resolved.PluginWeights(), q_extra, off[7], 16,
                                             key_dtype=kdt)
            for a, b in zip(resolved.schedule_keys(q_la, *off, 16, wide=wide), want):
                assert torch.equal(a, b)
        with pytest.raises(ValueError, match="LeastAllocated"):
            resolved.schedule_rounds(*carry, q_la, *off, 16, 16)
        with pytest.raises(ValueError, match="LeastAllocated"):
            resolved.schedule_refresh(carry, np.arange(16, dtype=np.int32), q_la, *off, 16)
        with pytest.raises(ValueError, match="LeastAllocated"):
            resolved.schedule_rounds_warm(carry, q_la, *off, 16, 16)
    # the round loop's keys: one lane, the padded node axis, a bool filter
    M, Mb, feas = carry
    for broken, match in (
        ((M.to(torch.int16), Mb, feas), "M: expected int32 or int64"),
        ((M, Mb.to(torch.int64), feas), "Mb"),
        ((M[:-16], Mb, feas), "M"),
        ((M, Mb[:-1], feas), "Mb"),
        ((M, Mb, feas.to(torch.uint8)), "la_feas_T"),
        ((M.to(torch.int64), Mb.to(torch.int64), feas[:, :-1]), "la_feas_T"),
    ):
        with pytest.raises(ValueError, match=match):
            resolved.schedule_rounds(*broken, q_la, *rest, 16, 16)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_checks_run_on_cpu_tensors():
    """The same checks on CPU tensors, where every wrapper takes its plain
    version: the script's comparison logic itself, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    x = _inputs(torch.device("cpu"), 300, 50)
    for cap in (1, 100):
        chip_smoke.check_kernels(x, cap, timed=False)
    chip_smoke.check_kernels(chip_smoke.ragged(x, 300, 50), 16, timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def _queue_inputs(num_nodes=40, num_pods=10):
    x = _inputs(torch.device("cpu"), num_nodes, num_pods)
    N = x["valid"].shape[0]
    _, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        x["la_pods"], x["nf_pods"], x["valid"], x["p_real"], x["order"])
    carry = resolved.schedule_keys(q_la, x["la_nodes"], x["weights"], q_nf, x["nf_nodes"],
                                   x["static"], x["valid"], pod_ok, salts, 16)
    rest = (x["la_nodes"], x["weights"], q_nf, x["nf_nodes"], x["static"], x["valid"], pod_ok,
            salts)
    return carry, q_la, rest, N


def test_warm_wrappers_refuse_before_launch():
    """Bad carries and dirty indices raise before any launch, on any
    device."""
    carry, q_la, rest, N = _queue_inputs()
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    ok = np.arange(16, dtype=np.int32)
    for bad, match in (
        (ok.astype(np.int64), "int32"),
        (np.array([0, N], dtype=np.int32), "outside"),
        (np.array([-1, 3], dtype=np.int32), "outside"),
    ):
        with pytest.raises(ValueError, match=match):
            resolved.schedule_refresh(carry, bad, q_la, *rest, 16)
    M, Mb, feas = carry
    for broken in ((M.to(torch.int64), Mb, feas), (M, Mb[:-1], feas), (M, Mb, feas.to(torch.int32))):
        with pytest.raises(ValueError, match="carry"):
            resolved.schedule_refresh(broken, ok, q_la, *rest, 16)
        with pytest.raises(ValueError, match="carry"):
            resolved.schedule_rounds_warm(broken, q_la, *rest, 16, 16)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_residency_wrappers_refuse_before_launch():
    rng = np.random.default_rng(0)
    host = [rng.integers(0, 9, size=(32, 2), dtype=np.int64), rng.random(32) < 0.5]
    bufs = sm.dstate_rows(host, torch.device("cpu"))
    idx = np.arange(16, dtype=np.int32)
    vals = tuple(h[idx] for h in host)
    for i, v, match in (
        (idx.astype(np.int64), vals, "int32"),
        (np.array([], dtype=np.int32), (), "non-empty"),
        (np.full(16, 32, dtype=np.int32), vals, "outside"),
        (idx, vals[:1], "value arrays"),
        (idx, (vals[0][:, :1], vals[1]), "array 0"),
        (idx, (vals[0], vals[1].astype(np.int64)), "array 1"),
    ):
        with pytest.raises(ValueError, match=match):
            sm.dstate_scatter(bufs, i, v)
    raw = [torch.zeros(8, 2, dtype=torch.int64)] * 12
    for k, t in ((3, torch.bool), (4, torch.float64), (6, torch.bool), (9, torch.bool),
                 (11, torch.bool)):
        raw[k] = torch.zeros(8, dtype=t)
    for k, wrong in ((4, torch.zeros(8, dtype=torch.float32)), (3, torch.zeros(7, dtype=torch.bool))):
        broken = list(raw)
        broken[k] = wrong
        with pytest.raises(ValueError, match=f"gate input {k}"):
            sm.dstate_gate(broken, 0.0, 180, True)
    sm.dstate_gate(raw, 0.0, 180, True)  # the well-formed rows pass
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    t = torch.zeros((4, 8), dtype=torch.int32)
    for bufs, widths, fills, match in (
        ([t] * 33, [16] * 33, [0] * 33, "33 buffers exceed 32"),
        ([t, torch.zeros((5, 8), dtype=torch.int32)], [16, 16], [0, 0], "buffer 1"),
        ([t], [7], [0], "buffer 0"),
        ([torch.zeros((8, 4), dtype=torch.int32).t()], [16], [0], "buffer 0"),
        ([torch.zeros((4, 8), dtype=torch.bool)], [16], [2], "fill 2"),
        ([], [], [], "0 buffers"),
    ):
        with pytest.raises(ValueError, match=match):
            sm.dstate_extend(bufs, widths, fills)
    assert len(sm.dstate_extend([t] * 32, [16] * 32, [-1] * 32)) == 32
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_warm_checks_run_on_cpu_tensors():
    """``chip_smoke``'s warm-kernel checks on CPU tensors, where every
    wrapper takes its plain version: the comparison logic, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_warm_kernels(_inputs(torch.device("cpu"), 300, 50), (16, 128), timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


CON = ("schedule_keys_con", "schedule_rounds_con", "sched_refresh_con", "sched_rounds_con",
       "rsv_rscore", "rsv_score")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods,cpd,cap", [
    (300, 50, 0, 16), (300, 50, 2, 1), (1000, 200, 0, 16), (1000, 200, 2, 100),
])
def test_con_kernels_equal_plain(card, num_nodes, num_pods, cpd, cap):
    """The constrained schedule kernels (gang, quota, reservation) against
    their plain versions: key build, round loop (taking the quota upper
    bound), refresh and warm rounds."""
    before = {k: cuda.KERNELS[k].launches for k in CON}
    chip_smoke.check_con_kernels(_inputs(card, num_nodes, num_pods), cpd, timed=False,
                                 commit_cap=cap)
    assert all(cuda.KERNELS[k].launches > before[k] for k in CON)


@pytest.mark.cuda
def test_quota_and_reservation_kernels_equal_plain(card):
    before = {k: cuda.KERNELS[k].launches for k in ("quota", "quota_limit")}
    chip_smoke.check_quota_kernels(card, timed=False)
    chip_smoke.check_rsv_kernels(_inputs(card, 1000, 200), timed=False)
    assert all(cuda.KERNELS[k].launches > before[k] for k in ("quota", "quota_limit"))


REFRESH_CASES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128, 1024])
@pytest.mark.parametrize("con,extras", REFRESH_CASES)
def test_refresh_one_launch_equals_plain(card, con, extras, D):
    """The one-launch refresh, plain and constrained, without and with
    extras, at the warm paths' buckets and above: equal to its plain
    version and to a cold key build, the first and last columns among the
    dirty rows, one launch a call."""
    rec = chip_smoke.check_refresh_case(_inputs(card, 2000, 200), con, extras, D)
    assert rec["launches"] == 1 and rec["D"] == D


@pytest.mark.cuda
@pytest.mark.parametrize("con", [False, True])
@pytest.mark.parametrize("nodes,D,route", [(2000, 1024, "large"), (5000, 4096, "copy")])
def test_refresh_plan_past_the_small_block(card, con, nodes, D, route):
    """Node blocks of one row, so that the plan has an entry a dirty row:
    ~1,021 entries ride in the 28-KB parameter block, ~4,093 (past its
    7,168 words) in a device copy; equal to the plain version and a cold
    key build, one launch a call either way."""
    rec = chip_smoke.check_refresh_case(_inputs(card, nodes, 200), con, False, D, BS=1)
    words = cuda.REFRESH_PARAM_WORDS
    assert rec["launches"] == 1 and (rec["plan_words"] > words) == (route == "copy")
    assert rec["plan_words"] > 512


@pytest.mark.cuda
@pytest.mark.parametrize("con", [False, True])
def test_refresh_is_one_device_activity(card, con):
    """A refresh call with the cycle's launch arguments (``warm_args``, as
    the engine calls it) is one device activity: no copy, no fill, one
    kernel."""
    x = _inputs(card, 1000, 200)
    s = chip_smoke.refresh_setup(x, con, False)
    args = (s["q_la"], x["la_nodes"], x["weights"], s["q_nf"], x["nf_nodes"], x["static"],
            x["valid"], s["pod_ok"], s["salts"])
    wa = resolved.warm_args(*args, s["con"])
    idx = chip_smoke.padded(np.arange(3, 900, 7, dtype=np.int32))
    ev = chip_smoke.device_events(
        lambda: resolved.schedule_refresh(s["carry"], idx, *args, 16, s["con"], None, wa), 5)
    assert chip_smoke.device_activities(ev) == 1, ev


@pytest.mark.cuda
def test_quota_tiers_equal_plain(card):
    """``quota`` and ``quota_limit`` in both memory tiers: each tree through
    its own tier (the 6,000-group tree past the shared memory) and forced to
    the global one, and without a stage."""
    from koordinator_tpu_torch.core import quota as tq
    from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

    tiers = {QuotaSnapshot(g, ["cpu", "memory"]).min.shape[0]: name
             for name, g in chip_smoke.quota_trees()}
    stages = {q: tq.QuotaStage().bind(np.zeros(q, dtype=np.int32), (), card).tier(2)
              for q in tiers}
    assert sorted(stages.values()) == ["global", "shared", "shared"], (tiers, stages)
    before = {k: cuda.KERNELS[k].launches for k in ("quota", "quota_limit")}
    chip_smoke.check_quota_kernels(card, timed=False)
    assert all(cuda.KERNELS[k].launches > before[k] for k in ("quota", "quota_limit"))


def test_refresh_cases_run_on_cpu_tensors():
    """``chip_smoke.check_refresh_case`` on CPU tensors, where the wrapper
    takes its plain version: the comparison logic, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    x = _inputs(torch.device("cpu"), 300, 50)
    for con, extras in REFRESH_CASES:
        rec = chip_smoke.check_refresh_case(x, con, extras, 64)
        assert rec["launches"] == 0 and rec["D"] == 64
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_con_checks_run_on_cpu_tensors():
    """``chip_smoke``'s constraint checks on CPU tensors, where every
    wrapper takes its plain version: the comparison logic, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    x = _inputs(torch.device("cpu"), 300, 50)
    for cpd in (0, 2):
        chip_smoke.check_con_kernels(x, cpd, timed=False)
    chip_smoke.check_rsv_kernels(x, timed=False)
    chip_smoke.check_quota_kernels(torch.device("cpu"), timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_con_wrappers_refuse_before_launch():
    """Bad dtypes and shapes of the constraint, quota and reservation
    inputs raise before any launch, on any device."""
    from koordinator_tpu_torch.core import quota as tq, reservation as tr
    from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

    cpu = torch.device("cpu")
    x = _inputs(cpu, 40, 10)
    gangs, quota, rsv, matched, midx, rank = chip_smoke.con_inputs_for(x, 1)
    xs, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        x["la_pods"], x["nf_pods"], x["valid"], x["p_real"], x["order"])
    req, N = x["nf_pods"].req, x["valid"].shape[0]
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    with pytest.raises(ValueError, match="reservation node"):
        tr.rsv_rscore(req, rsv._replace(node=rsv.node.long()))
    with pytest.raises(ValueError, match="matched"):
        tr.rsv_score(req, matched[:, :-1], N, rsv, rank)
    with pytest.raises(ValueError, match="reservation rank"):
        tr.rsv_score(req, matched, N, rsv, rank.int())
    with pytest.raises(ValueError, match="matched"):
        tr.rsv_rows(req, matched[:, :-1], N, rsv, rank)
    with pytest.raises(ValueError, match="reservation allocated"):
        tr.rsv_rows(req, matched, N, rsv._replace(allocated=rsv.allocated.int()), rank)
    con = chip_smoke.con_for(x, (gangs, quota, rsv, matched, midx, rank), xs)
    args = (q_la, x["la_nodes"], x["weights"], q_nf, x["nf_nodes"], x["static"], x["valid"],
            pod_ok, salts, 16)
    for bad, match in (
        (con._replace(gang_row=con.gang_row.long()), "gang rows"),
        (con._replace(rsv_midx=con.rsv_midx[:, :1].long()), "match index"),
        (con._replace(quota=con.quota._replace(limit=con.quota.limit.int())), "quota limit"),
        (con._replace(rsv_scores=con.rsv_scores[:, :-1]), "reservation scores"),
    ):
        with pytest.raises(ValueError, match=match):
            resolved.schedule_keys(*args, bad)
    M, Mb, feas = resolved.schedule_keys(*args, con)
    with pytest.raises(ValueError, match="check_parent_depth"):
        resolved.schedule_rounds(M, Mb, feas, *args[:-1], 16, 16, con, 8, 8)
    snap = QuotaSnapshot(chip_smoke.quota_trees()[1][1], ["cpu", "memory"])
    qa = tq.QuotaArrays(*(torch.from_numpy(np.asarray(a)) for a in snap.arrays()))
    total = torch.tensor([9000, 900])
    with pytest.raises(ValueError, match="quota parent"):
        tq.quota_fn(qa._replace(parent=qa.parent.long()), snap.level_tuple(), total)
    with pytest.raises(ValueError, match="level rows"):
        tq.quota_limit_fn(qa, (np.array([0, 1]),), total)
    with pytest.raises(ValueError, match="cluster total"):
        tq.quota_fn(qa, snap.level_tuple(), total.int())
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


PLACE = ("placement", "dev_feasible", "ds_score", "dstate_extend")
EXTRA = ("score", "schedule_keys", "schedule_rounds", "sched_refresh", "sched_rounds",
         "schedule_keys_con", "schedule_rounds_con", "sched_refresh_con", "sched_rounds_con")


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,Lb,Gm", [(32, 600, 700, 8), (256, 2048, 4096, 16)])
def test_placement_and_device_kernels_equal_plain(card, M, N, Lb, Gm):
    """``placement``, ``dev_feasible``, ``ds_score`` and ``dstate_extend``
    against their plain versions, exactly."""
    before = {k: cuda.KERNELS[k].launches for k in PLACE}
    chip_smoke.check_placement_kernel(card, M, N, Lb, timed=False)
    chip_smoke.check_device_kernels(card, 16, N, Gm, timed=False)
    chip_smoke.check_extend_kernel(card, N, timed=False)
    assert all(cuda.KERNELS[k].launches > before[k] for k in PLACE)


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods,con,cap", [
    (300, 50, False, 16), (300, 50, True, 1), (1000, 200, True, 16), (1000, 200, False, 100),
])
def test_extra_channel_kernels_equal_plain(card, num_nodes, num_pods, con, cap):
    """The score and schedule kernels with a random placement mask and
    extra scores against their plain versions; neutral extras repeat the
    launches without them, round counts included."""
    before = {k: cuda.KERNELS[k].launches for k in EXTRA}
    chip_smoke.check_extra_kernels(_inputs(card, num_nodes, num_pods), con, timed=False,
                                   commit_cap=cap)
    tag = "_con" if con else ""
    assert all(cuda.KERNELS[k + tag].launches > before[k + tag]
               for k in ("schedule_keys", "schedule_rounds", "sched_refresh", "sched_rounds"))


def test_placement_checks_run_on_cpu_tensors():
    """``chip_smoke``'s placement, device, extension and extra-channel
    checks on CPU tensors, where every wrapper takes its plain version: the
    comparison logic, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    chip_smoke.check_placement_kernel(cpu, 32, 600, 700, timed=False)
    chip_smoke.check_device_kernels(cpu, 16, 500, 16, timed=False)
    chip_smoke.check_extend_kernel(cpu, 300, timed=False)
    x = _inputs(cpu, 300, 50)
    for con in (False, True):
        chip_smoke.check_extra_kernels(x, con, timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_placement_and_device_wrappers_refuse_before_launch():
    """Bad dtypes and shapes of the new kernels' inputs and of the extra
    channel raise before any launch, on any device."""
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.core.cycle import score_fn

    cpu = torch.device("cpu")
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    (core, mem, full, vfs, sigs), (req, alloc2, used2) = chip_smoke.device_inputs(cpu, 8, 50, 8, 0)
    with pytest.raises(ValueError, match="mem"):
        pl.dev_feasible(core, mem[:, :4], full, vfs, sigs)
    with pytest.raises(ValueError, match="vfs"):
        pl.dev_feasible(core, mem, full, vfs.long(), sigs)
    with pytest.raises(ValueError, match="count"):
        pl.dev_feasible(core, mem, full, vfs, sigs._replace(count=sigs.count[:3]))
    with pytest.raises(ValueError, match="req"):
        pl.ds_score(req.int(), alloc2, used2)
    with pytest.raises(ValueError, match="used2"):
        pl.ds_score(req, alloc2, used2[:, :1])
    psigs, rows = chip_smoke.placement_inputs(cpu, 8, 50, 64, 0)
    with pytest.raises(ValueError, match="aa_cnt"):
        pl.placement(psigs, rows[0], rows[1], rows[2].long(), rows[3])
    with pytest.raises(ValueError, match="sel_cnt"):
        pl.placement(psigs._replace(sel_cnt=psigs.sel_cnt.long()), *rows)
    with pytest.raises(ValueError, match="cannot widen"):
        sm.dstate_extend([torch.zeros((4, 8), dtype=torch.float32)], [16], [0])
    with pytest.raises(ValueError, match="widths"):
        sm.dstate_extend([torch.zeros((4, 8), dtype=torch.int32)], [16, 32], [0])
    x = _inputs(cpu, 40, 10)
    P, N = x["la_pods"].est.shape[0], x["valid"].shape[0]
    args = (x["la_pods"], x["la_nodes"], x["weights"], x["nf_pods"], x["nf_nodes"], x["static"],
            x["valid"])
    with pytest.raises(ValueError, match="extra_scores"):
        score_fn(*args, torch.zeros((P, N), dtype=torch.int32))
    _, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        x["la_pods"], x["nf_pods"], x["valid"], x["p_real"], x["order"])
    keys = (q_la, x["la_nodes"], x["weights"], q_nf, x["nf_nodes"], x["static"], x["valid"],
            pod_ok, salts, 16)
    for xin, match in (
        (resolved.ExtraInputs(feas=torch.ones((P, N), dtype=torch.bool), scores=None),
         "extra feasibility"),
        (resolved.ExtraInputs(feas=None, scores=torch.zeros((N, P), dtype=torch.int32)),
         "extra scores"),
    ):
        with pytest.raises(ValueError, match=match):
            resolved.schedule_keys(*keys, None, xin)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_placement_phase_runs_on_cpu():
    """``chip_smoke``'s placement-and-devices phase at a small fleet on the
    CPU, every engine on the plain versions: its twins, demotions, table
    extensions and the stores' device state hold (the launch plan is the
    card's alone), and nothing launches: the phase sets every count to 0
    as it starts, and they stay there."""
    launches, records = chip_smoke.drive_placement_path(torch.device("cpu"), 600, 300, SCALARS)
    assert [r["extends"] for r in records][3] == 2 and all(r["placed"] for r in records)
    assert not any(launches.values())


STRAT = ("score", "scan", "scan_con", "schedule_keys64", "schedule_rounds64",
         "schedule_keys64_con", "schedule_rounds64_con", "schedule_keys", "schedule_keys_con")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods", [(300, 50), (1000, 200)])
def test_strategy_kernels_equal_plain(card, num_nodes, num_pods):
    """``score`` under MostAllocated and RTC (both shapes), the key build
    under them, the scan (the int64 key build and the step kernel, plain
    and constrained, both tie-breaks, with and without extras,
    check_parent_depth 0 and 2; against both plain routes and layer by
    layer) and the int64-key matrix engine (plain and constrained, its
    round count the int32 engine's) against their plain versions,
    exactly."""
    before = {k: cuda.KERNELS[k].launches for k in STRAT}
    chip_smoke.check_strategies_small(_inputs(card, num_nodes, num_pods))
    assert all(cuda.KERNELS[k].launches > before[k] for k in STRAT)


@pytest.mark.cuda
def test_scan_kernel_ragged_and_partial(card):
    """The scan on a node axis that is not a multiple of its block width,
    a pod axis that is not a power of two and a shuffled queue order."""
    x = chip_smoke.ragged(_inputs(card, 300, 50), 301 - 34, 45)
    for _, static in chip_smoke.strategy_statics(x["static"]):
        for con in (False, True):
            chip_smoke.check_scan_kernels(x, static, con, "salted", True, timed=False)


@pytest.mark.cuda
def test_scan_edges_equal_plain(card):
    """The step kernel's invariant cases at 64 x 512 (an empty fleet, the
    constraint inputs, the most negative total, every pod infeasible, one
    pod, padding pods, block sizes 7 and 64), and on clusters of their own
    1,030 pods (more than the step kernel's threads) and 1,100 block
    maxima in blocks of 1 (more than its threads): the scan equals both plain
    routes, and layer by layer the key build's M, Mb and the step kernel's
    hosts, scores and updated M, Mb equal theirs."""
    keys = ("scan", "scan_con", "schedule_keys64", "schedule_keys64_con")
    before = {k: cuda.KERNELS[k].launches for k in keys}
    chip_smoke.check_scan_edges(_inputs(card, 500, 64))
    assert all(cuda.KERNELS[k].launches > before[k] for k in keys)


@pytest.mark.cuda
def test_key_builds_equal_plain(card):
    """The key build under MostAllocated and RTC (both shapes), plain and
    constrained, int32 and int64 keys, against ``build_keys_plain``."""
    before = cuda.KERNELS["schedule_keys64_con"].launches
    chip_smoke.check_key_builds(_inputs(card, 1000, 200), timed=False)
    assert cuda.KERNELS["schedule_keys64_con"].launches > before


@pytest.mark.cuda
def test_division_helper_equals_slash(card):
    """pair.cuh's exact division by a capacity's reciprocal and its 32-bit
    division, against `/` and exact integer division, on edge operands."""
    assert chip_smoke.check_div_helper(card) > 1000


def test_scan_edges_run_on_cpu_tensors():
    """``chip_smoke``'s scan invariant cases on CPU tensors, where the
    wrappers take their plain versions: the cases build, each property
    holds (every pod infeasible places none, the rest place some), and
    nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_scan_edges(_inputs(torch.device("cpu"), 200, 40))
    chip_smoke.check_key_builds(_inputs(torch.device("cpu"), 60, 20), timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_strategy_checks_run_on_cpu_tensors():
    """``chip_smoke``'s strategy checks on CPU tensors, where every wrapper
    takes its plain version: the comparison logic (the int64-key round
    loop's plain version against the plain matrix engine), and no
    launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_strategies_small(_inputs(torch.device("cpu"), 300, 50))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_scan_wrapper_refuses_before_launch():
    """The scan's wrapper checks its inputs before any launch: a tie-break
    it does not know, extra scores of another dtype or shape, and tensors
    on a device that is neither the CPU nor a card, handed to the launch
    or to the step kernel itself."""
    from koordinator_tpu_torch.core import cycle

    x = _inputs(torch.device("cpu"), 40, 10)
    P, N = x["la_pods"].est.shape[0], x["valid"].shape[0]
    args = (x["la_pods"], x["la_nodes"], x["weights"], x["nf_pods"], x["nf_nodes"], x["static"],
            x["valid"], x["p_real"], x["order"])
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    with pytest.raises(ValueError, match="tie_break"):
        cycle.scan_fn(*args, tie_break="random")
    with pytest.raises(ValueError, match="extra_scores"):
        cycle.scan_fn(*args, extra_scores=torch.zeros((P, N), dtype=torch.int32))
    _, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        x["la_pods"], x["nf_pods"], x["valid"], x["p_real"], x["order"])
    meta = torch.device("meta")
    valid = x["valid"].to(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cycle.scan_launch(q_la, x["la_nodes"], x["weights"], q_nf, x["nf_nodes"], x["static"],
                          valid, pod_ok, salts)
    M = torch.empty((-(-N // 16) * 16, P), dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cycle.scan_steps(M, M[::16], q_la, x["la_nodes"], x["weights"], q_nf, x["nf_nodes"],
                         x["static"], valid, pod_ok, salts, 16)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_strategy_phase_runs_on_cpu():
    """``chip_smoke``'s strategies phase at a small fleet on the CPU, every
    engine on the plain versions: its twins, the stores after ``assume``,
    the reserve pods and demotions hold (the launch plan is the card's
    alone), and nothing launches."""
    launches, records = chip_smoke.drive_strategy_path(torch.device("cpu"), 600, 300, SCALARS)
    assert len(records) == len(chip_smoke.MOST_CYCLES) + len(chip_smoke.RTC_CYCLES)
    assert all(r["placed"] for r in records) and not any(launches.values())


BREAKDOWN = ("la_score", "nf_score", "loadaware_score_and_filter")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods", [(500, 64), (1000, 200)])
def test_breakdown_kernels_equal_plain(card, num_nodes, num_pods):
    """``la_score``, ``nf_score`` (LeastAllocated, MostAllocated, RTC at both
    shapes) and ``loadaware_score_and_filter`` against their plain
    versions, exactly."""
    before = {k: cuda.KERNELS[k].launches for k in BREAKDOWN}
    chip_smoke.check_breakdown_kernels(_inputs(card, num_nodes, num_pods), timed=False)
    assert all(cuda.KERNELS[k].launches > before[k] for k in BREAKDOWN)


@pytest.mark.cuda
def test_breakdown_kernels_ragged(card):
    """A node axis that is not a multiple of the block width and a pod axis
    that is not a power of two."""
    chip_smoke.check_breakdown_kernels(chip_smoke.ragged(_inputs(card, 300, 50), 300 - 33, 45),
                                       timed=False)


def test_breakdown_checks_run_on_cpu_tensors():
    """The explain slice's checks on CPU tensors, where every wrapper takes
    its plain version: the comparison logic itself, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_breakdown_kernels(_inputs(torch.device("cpu"), 500, 64), timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_breakdown_wrappers_refuse_before_launch():
    """The argument builders take CUDA tensors only and check axes, dtypes
    and shapes before any launch."""
    x = _inputs(torch.device("cpu"), 40, 10)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.loadaware_args(x["la_pods"], x["la_nodes"], x["weights"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.nodefit_args(x["nf_pods"], x["nf_nodes"], x["static"])
    meta = torch.device("meta")
    la_pods = type(x["la_pods"])(*(a.to(meta) for a in x["la_pods"]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.loadaware_args(la_pods, x["la_nodes"], x["weights"])
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


LA = ("la_score", "loadaware_score_and_filter")
LA_CASES = 15  # len(chip_smoke.la_cases(..., small))


@pytest.mark.cuda
def test_la_cases_equal_plain(card):
    """The LoadAware strip (``la_score`` and ``loadaware_score_and_filter``)
    on its edge cases: a ragged 267 x 45, one pod, a pod axis off the
    strip, the quotient boundaries, R = 1 and 3, rows off the float
    estimate's range, negative, zero and large weights, nodes without a
    live NodeMetric, DaemonSet pods, zero prod thresholds, both filters off
    and wrapping usages; each equal to its plain versions, one launch a
    call."""
    before = {k: cuda.KERNELS[k].launches for k in LA}
    assert chip_smoke.check_la_cases(card, _inputs(card, 300, 50)) == LA_CASES
    assert all(cuda.KERNELS[k].launches == before[k] + LA_CASES for k in LA)


def test_la_cases_run_on_cpu_tensors():
    """The LoadAware strip's edge cases on CPU tensors, where the wrappers
    take the plain versions: the cases build and compare (none of them
    mismatches), and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    small = _inputs(cpu, 300, 50)
    assert chip_smoke.check_la_cases(cpu, small) == LA_CASES
    assert chip_smoke.la_case_faults(cpu, small) == {}
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


NF_CASES = 16 * 4  # len(chip_smoke.nf_cases(..., small)) x the four strategy shapes


@pytest.mark.cuda
def test_nf_cases_equal_plain(card):
    """The NodeFit strip (``nf_score``) on its edge cases under
    LeastAllocated, MostAllocated and both RTC shapes: a ragged 267 x 45,
    one pod, a pod axis off the strip, the quotient boundaries, Rs = 1, 3, 5
    and 8, rows off the float estimate's range, negative, zero, large and
    wrapping weights, bypassed zero requests; each equal to
    ``nodefit_score_plain``, one launch a call."""
    before = cuda.KERNELS["nf_score"].launches
    assert chip_smoke.check_nf_cases(card, _inputs(card, 300, 50)) == NF_CASES
    assert cuda.KERNELS["nf_score"].launches == before + NF_CASES


def test_nf_cases_run_on_cpu_tensors():
    """The NodeFit strip's edge cases on CPU tensors, where the wrapper
    takes the plain version: the cases build and compare (none of them
    mismatches), and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    small = _inputs(cpu, 300, 50)
    assert chip_smoke.check_nf_cases(cpu, small) == NF_CASES
    assert chip_smoke.nf_case_faults(cpu, small) == {}
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


DEV_CASES = 11  # len(chip_smoke.dev_cases(...))


@pytest.mark.cuda
def test_dev_cases_equal_plain(card):
    """``dev_feasible`` on its edge cases: Gm 1, 6, 8 and 16, M 0, 1 and
    200 (past the launch parameters' cap), N 0 and 333, invalid counts,
    RDMA-only signatures, every slot padded; each equal to
    ``dev_feasible_plain``; strided rows refused, a moved row rebound,
    signatures on the card refused before any launch."""
    before = cuda.KERNELS["dev_feasible"].launches
    assert chip_smoke.check_dev_cases(card) == DEV_CASES
    assert cuda.KERNELS["dev_feasible"].launches > before


def test_dev_cases_run_on_cpu_tensors():
    """The device feasibility's edge cases on CPU tensors, where the stage
    takes the plain version: the cases build and compare, the strided rows
    are refused and the moved row rebound, and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    assert chip_smoke.check_dev_cases(cpu) == DEV_CASES
    assert chip_smoke.dev_case_faults(cpu) == {"strided rows": "refused", "moved row": "equal"}
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


DS_CASES = 9  # len(chip_smoke.ds_cases(...))


@pytest.mark.cuda
def test_ds_cases_equal_plain(card):
    """``ds_score`` on its edge cases (a capacity of 0 in one dimension,
    requests of 0, used above capacity, negative used and capacities,
    totals past 2**31 / 100, unaligned rows, M 0, N 0) through the public
    call and a ``DeviceStage`` at weights 1, 7 and -3, and through a stage
    over the six device rows at M = 16, the launch parameters' cap and
    past it, Gm 8 and 16, at weight 1, the numa weight, 7 and -3: each
    equal to ``ds_score_plain`` times the weight; requests on the card
    refused before any launch."""
    before = cuda.KERNELS["ds_score"].launches
    assert chip_smoke.check_ds_cases(card) == DS_CASES
    for Gm in (8, 16):
        assert chip_smoke.check_ds_stage(card, 333, Gm, 50 + Gm) == 0
    assert cuda.KERNELS["ds_score"].launches > before


def test_ds_cases_run_on_cpu_tensors():
    """The deviceshare score's edge cases and the stage's requests counts
    on CPU tensors, where the stage takes the plain version: the cases
    build what they name and compare, and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    assert chip_smoke.check_ds_cases(cpu) == DS_CASES
    assert chip_smoke.check_ds_stage(cpu, 90, 8, 3) == 0
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def _adoption_host():
    """The rows a store's three resident tables hold, at 300 nodes."""
    from koordinator_tpu_torch.service.state import ClusterState

    st = ClusterState(extra_scalars=SCALARS)
    for node in random_cluster(9, num_nodes=300, num_pods=0)[1]:
        st.upsert_node(node)
    return st, [getattr(st, a) for a in sm.DeviceResidency._ROWS + sm.DeviceResidency._POLICY
                + sm.DeviceResidency._DEVICE]


@pytest.mark.cuda
def test_adoption_on_the_card(card):
    """``dstate_rows`` on the card: two adoptions back to back, the second
    on changed arrays with no synchronisation between them (they share the
    module's pinned staging), each buffer equal to its host array byte for
    byte, 256-byte aligned, one slab an adoption; a store's residency on
    the card adopts its three tables so, and its audit passes."""
    st, host = _adoption_host()
    chip_smoke.check_adoption(sm, host, card)
    res = st.residency
    res.serving_node_inputs(1.0, card)
    res.policy_rows(card)
    res.device_rows(card)
    for name, t in res._tables.items():
        assert chip_smoke.slab_fault(t.bufs, card) is None, name
    assert res.full_uploads == 3 and res.verify() == len(host)


def test_adoption_checks_run_on_cpu_tensors():
    """The adoption's card check on the CPU route, which packs as the
    card's does: two adoptions back to back equal their host arrays and
    are aligned views of one slab each; nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    _, host = _adoption_host()
    chip_smoke.check_adoption(sm, host, torch.device("cpu"))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


REPAIR = ("score", "shard_score_map", "nf_score", "schedule_keys", "schedule_rounds",
          "schedule_keys64", "schedule_keys_con", "scan", "sched_refresh", "sched_refresh_con")


@pytest.mark.cuda
def test_repair_cases_equal_plain(card):
    """The floored divisions and the bounded weights: negative LoadAware
    and NodeFit weights, negative request totals and weight sums that wrap
    to 1, through ``score``, ``shard_score_map``, ``nf_score``, the key
    builds, the round loop, the scan and ``sched_refresh``, each equal to
    its plain version."""
    before = {k: cuda.KERNELS[k].launches for k in REPAIR}
    assert chip_smoke.check_repair_cases(card) == 4 * 7
    assert all(cuda.KERNELS[k].launches > before[k] for k in REPAIR)


def test_repair_cases_run_on_cpu_tensors():
    """The repair cases on CPU tensors, where every wrapper takes its plain
    version: each case builds what it names, the checks compare, and
    nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    assert chip_smoke.check_repair_cases(torch.device("cpu")) == 4 * 7
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_nodefit_args_layout(monkeypatch):
    """``nodefit_args`` lays out what the NodeFit strip reads: null
    LoadAware entries and the NodeFit tables at the tensors' addresses, and
    the configuration block of (0, 0, Rs) and the static, built once per
    (Rs, static) and shared (``cfg_array``'s cache)."""
    import ctypes
    import dataclasses

    monkeypatch.setattr(cuda, "_cuda_device", lambda t: t.device)  # lay out CPU tensors
    x = _inputs(torch.device("cpu"), 40, 10)
    nf_pods, nf_nodes, static = x["nf_pods"], x["nf_nodes"], x["static"]
    Rs = nf_pods.req_score.shape[1]
    args = cuda.nodefit_args(nf_pods, nf_nodes, static)
    pods = list((ctypes.c_uint64 * 7).from_address(args.pods))
    nodes = list((ctypes.c_uint64 * 17).from_address(args.nodes))
    assert pods == [0] * 4 + [t.data_ptr() for t in nf_pods]
    assert nodes == [0] * 11 + [t.data_ptr() for t in nf_nodes]
    block = cuda.cfg_array(0, 0, Rs, static)
    assert args.cfg == ctypes.addressof(block)
    assert list(block)[:3] == [0, 0, Rs]
    assert list(block)[3:3 + Rs] == list(static.weights)
    assert cuda.nodefit_args(nf_pods, nf_nodes, static).cfg == args.cfg
    most = dataclasses.replace(static, strategy="MostAllocated")
    assert cuda.nodefit_args(nf_pods, nf_nodes, most).cfg != args.cfg
    assert cuda.cfg_array(0, 0, Rs, most)[3 + 3 * cuda.MAXR] == 1


def test_loadaware_args_layout(monkeypatch):
    """``loadaware_args`` lays out what the strip kernel reads: the pod and
    node tables' LoadAware entries at the tensors' addresses and null
    NodeFit entries, the weights, and the configuration block of R, which
    is built once per R and shared (``loadaware_cfg``)."""
    import ctypes

    monkeypatch.setattr(cuda, "_cuda_device", lambda t: t.device)  # lay out CPU tensors
    x = _inputs(torch.device("cpu"), 40, 10)
    la_pods, la_nodes, w = x["la_pods"], x["la_nodes"], x["weights"]
    R = la_pods.est.shape[1]
    args = cuda.loadaware_args(la_pods, la_nodes, w)
    pods = list((ctypes.c_uint64 * 7).from_address(args.pods))
    nodes = list((ctypes.c_uint64 * 17).from_address(args.nodes))
    assert pods == [t.data_ptr() for t in la_pods] + [0] * 3
    assert nodes == [t.data_ptr() for t in la_nodes] + [0] * 6
    assert args.la_w == w.data_ptr() and args.valid == 0
    block = cuda.loadaware_cfg(R)
    assert args.cfg == ctypes.addressof(block) and cuda.loadaware_cfg(R) is block
    assert list(block) == [R, 0, 0] + [0] * (cuda.CFG_LEN - 3)
    assert cuda.loadaware_cfg(3) is not block and list(cuda.loadaware_cfg(3))[:3] == [3, 0, 0]


def test_library_and_sidecar_phases_run_on_cpu():
    """``chip_smoke``'s library call and sidecar phase at a small fleet on
    the CPU (the "card's" sidecar on the CPU too): every reply of the two
    sidecars byte-identical, EXPLAIN equal to the probe SCHEDULE, and
    nothing launches (the launch plan is the card's alone)."""
    launches, wall = chip_smoke.drive_library_path(torch.device("cpu"), 300, 40)
    assert not any(launches.values())
    launches, verbs, (desched, ticks, fleet) = chip_smoke.drive_sidecar_path(
        torch.device("cpu"), 300, 64, SCALARS)
    assert not any(launches.values()) and not any(desched.values())
    assert [v["verb"] for v in verbs][-1] == "METRICS (refused)"
    assert next(v for v in verbs if v["verb"] == "ECHO")["bytes"] > 1024 * 16384 * 2
    assert ticks[-1]["verb"] == "DESCHEDULE execute" and ticks[-1]["executed"]
    assert fleet["nodes"].usage.shape == (300, 2)


@pytest.mark.cuda
def test_desched_kernels_equal_plain(card):
    """``deschedule_round`` at 300 nodes x 50 candidates (bucket 64) across
    deviation, debounce, caps and the number_of_nodes gate, and
    ``pod_band_rank`` at P = 64 with ties on every key."""
    before = {k: cuda.KERNELS[k].launches for k in ("deschedule_round", "pod_band_rank")}
    chip_smoke.check_desched_kernels(card, timed=False)
    chip_smoke.check_band_kernels(card, timed=False)
    assert all(cuda.KERNELS[k].launches > v for k, v in before.items())


@pytest.mark.cuda
def test_desched_round_one_copy_to_host(card):
    """The round's outputs share one buffer: ``to_host`` brings them over
    in one copy, equal to the plain version's."""
    from koordinator_tpu_torch.core import deschedule as ds
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    nodes, pods = chip_smoke.desched_arrays(card, 200, 40, 64, 5)
    args = (new_anomaly_state(200, card), nodes, pods, torch.tensor([30.0, 40.0], device=card),
            torch.tensor([60.0, 80.0], device=card), torch.tensor([1, 1], device=card))
    got = ds.to_host(ds.deschedule_round(*args, consecutive_abnormalities=1))
    want = ds.deschedule_round_plain(*args, consecutive_abnormalities=1)
    for a, b in zip(chip_smoke.round_outputs(got), chip_smoke.round_outputs(want)):
        assert np.array_equal(a, b.cpu().numpy())


def test_desched_checks_run_on_cpu_tensors():
    """The descheduler's checks on CPU tensors, where both wrappers take
    their plain versions: the comparison logic itself, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_desched_kernels(torch.device("cpu"), timed=False)
    chip_smoke.check_band_kernels(torch.device("cpu"), timed=False)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_desched_wrappers_refuse_before_launch():
    """Wrong dtypes and shapes raise before any launch."""
    from koordinator_tpu_torch.core import deschedule as ds
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    nodes, pods = chip_smoke.desched_arrays(torch.device("cpu"), 20, 10, 16, 1)
    low, high = torch.tensor([30.0, 40.0]), torch.tensor([60.0, 80.0])
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    with pytest.raises(ValueError, match="pod usage"):
        ds.deschedule_round(new_anomaly_state(20), nodes, pods._replace(usage=pods.usage[:, :1]),
                            low, high, torch.tensor([1, 1]))
    with pytest.raises(ValueError, match="anomaly"):
        ds.deschedule_round(new_anomaly_state(19), nodes, pods, low, high, torch.tensor([1, 1]))
    keys = chip_smoke.band_arrays(torch.device("cpu"), 8, 1, usage=False)
    with pytest.raises(ValueError, match="create_time"):
        ds.pod_band_rank(keys._replace(create_time=keys.create_time.float()))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


@pytest.mark.cuda
def test_score_cases_equal_plain(card):
    """The score kernel on its edge cases (a ragged 267 x 45, one pod,
    every pair infeasible, the quotient boundaries, a bypassed zero
    request, the generic instantiation) under the four strategy shapes,
    without and with extra scores."""
    before = cuda.KERNELS["score"].launches
    n = chip_smoke.check_score_cases(card, _inputs(card, 300, 50))
    assert cuda.KERNELS["score"].launches == before + n


@pytest.mark.cuda
def test_desched_cases_equal_plain(card):
    """The round on its edge cases over three rounds each: equal high
    digits over many blocks, keys spanning 64 bits, N = 1, Pc = 1, caps of
    0, 1 and unlimited, deviation off and on."""
    before = cuda.KERNELS["deschedule_round"].launches
    n = chip_smoke.check_desched_cases(card)
    assert cuda.KERNELS["deschedule_round"].launches == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 7, 64])
def test_desched_round_any_grid(card, monkeypatch, G):
    """The round's outputs do not depend on its main blocks: a pool of
    2,000 nodes x 4,096 candidates (deviation on) under G of 1 to 64."""
    from koordinator_tpu_torch.core import deschedule as ds
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    nodes, pods = chip_smoke.desched_arrays(card, 2000, 3000, 4096, 11)
    args = (new_anomaly_state(2000, card), nodes, pods,
            torch.tensor([10.0, 10.0], dtype=torch.float64, device=card),
            torch.tensor([10.0, 10.0], dtype=torch.float64, device=card),
            torch.tensor([1, 2], device=card))
    kw = dict(use_deviation=True, consecutive_abnormalities=1, per_node_cap=2, total_cap=900)
    want = ds.deschedule_round_plain(*args, **kw)
    monkeypatch.setattr(cuda, "desched_grid", lambda *a: G)
    got = ds.deschedule_round(*args, **kw)
    chip_smoke.require_equal(f"G={G}", chip_smoke.round_outputs(got),
                             chip_smoke.round_outputs(want))
    chip_smoke.require_same_util(f"G={G}", got.util_pct, want.util_pct)


RSV_CASES = 14  # len(chip_smoke.rsv_cases(...))


@pytest.mark.cuda
def test_rsv_cases_equal_plain(card):
    """The reservation rows' one launch (``rsv_rows``) and the two entry
    points on their edge cases: one pod in the bucket of 16, Rv = 1, 257
    and RSV_MAX, a pod with no match, an all-zero row, several
    reservations on one node with and without ranks, equal rscores,
    capacity-0 dimensions and w = 0, a pod matching every reservation, N
    odd, N = 1 and N > 2**16, values past the fast quotients' range; each
    equal to ``score_reservation`` and ``reservation_score``."""
    before = {k: cuda.KERNELS[k].launches for k in ("rsv_rscore", "rsv_score")}
    assert chip_smoke.check_rsv_cases(card) == RSV_CASES
    assert cuda.KERNELS["rsv_score"].launches == before["rsv_score"] + 2 * RSV_CASES
    assert cuda.KERNELS["rsv_rscore"].launches == before["rsv_rscore"] + RSV_CASES


def test_rsv_cases_run_on_cpu_tensors():
    """The reservation rows' edge cases on CPU tensors, where the wrappers
    take the plain versions: the cases build and compare, and nothing
    launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    assert chip_smoke.check_rsv_cases(torch.device("cpu")) == RSV_CASES
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_score_cases_run_on_cpu_tensors():
    """The score kernel's edge cases on CPU tensors, where the wrapper
    takes the plain version: the cases build and compare, and nothing
    launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    assert chip_smoke.check_score_cases(cpu, _inputs(cpu, 300, 50)) == 7 * 4 * 2
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_desched_cases_run_on_cpu_tensors():
    """The round's edge cases on CPU tensors: three rounds of each of the
    16 (cases x deviation mode), and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    assert chip_smoke.check_desched_cases(torch.device("cpu")) == 16 * 3
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_score_boundaries_sweep_every_step():
    """The boundary case puts, for every capacity, the free capacity n =
    cap - used of a LoadAware quotient n * 100 // cap on both sides of
    every integer step k in 1..100 (the least n reaching k, and the one
    before it), and used == cap and used > cap somewhere."""
    inp = chip_smoke.boundary_inputs(torch.device("cpu"), 3)
    cap = inp["la_nodes"].alloc[:, 0].tolist()
    base = inp["la_nodes"].base_nonprod[:, 0].tolist()
    seen = {}
    for j, c in enumerate(cap):
        seen.setdefault(c, set()).update(c - (q + base[j]) for q in range(8))
    assert sorted(seen) == sorted(set(chip_smoke.BOUNDARY_CAPS) | {0})
    for c in chip_smoke.BOUNDARY_CAPS:
        for k in range(1, 101):
            step = -(-k * c // 100)  # the least n with n * 100 // c >= k
            assert step * 100 // c >= k > (step - 1) * 100 // c
            assert {step, step - 1} <= seen[c]
    n = [c - (q + b) for c, b in zip(cap, base) for q in range(8) if c > 0]
    assert 0 in n and min(n) < 0 and 0 in cap


def test_score_widths_take_an_instantiation():
    """The widths the serving configurations reach (batch scalars or not)
    each have a specialised instantiation in csrc/score.cu, chosen by
    ``koord_score``; any other width takes the generic one."""
    import re

    src = (cuda.CSRC / "score.cu").read_text()
    chosen = re.findall(r"c\.R == (\d+) && c\.Rf == (\d+) && c\.Rs == (\d+)\)\s*\n\s*"
                        r"e = launch_widths<(\d+), (\d+), (\d+)>", src)
    assert chosen and all(a[:3] == a[3:] for a in chosen)
    assert "launch_widths<0, 0, 0>" in src
    widths = set()
    for scalars in ((), SCALARS):
        pods, nodes = random_cluster(3, num_nodes=20, num_pods=5)
        inp = chip_smoke.build_inputs(pods, nodes, torch.device("cpu"), scalars)
        widths.add((inp["la_pods"].est.shape[1], inp["nf_pods"].req.shape[1],
                    inp["nf_pods"].req_score.shape[1]))
    assert widths == {(2, 3, 2), (2, 5, 2)}
    assert widths <= {tuple(int(x) for x in a[:3]) for a in chosen}


def test_desched_grid_reckoning():
    """The round's launch: a main block a 1,024 positions of the larger
    axis, at most 132 and what the card's SMs leave beside the side blocks
    (6R, one more in deviation mode), at least one."""
    assert cuda.desched_side_blocks(2, False) == 12
    assert cuda.desched_side_blocks(2, True) == 13
    assert cuda.desched_grid(10_000, 32_768, 2, False, 132) == 32
    assert cuda.desched_grid(10_000, 64, 2, True, 132) == 10
    assert cuda.desched_grid(300, 64, 2, False, 132) == 1
    assert cuda.desched_grid(1, 1, 1, False, 132) == 1
    assert cuda.desched_grid(500_000, 500_000, 2, False, 132) == 120
    assert cuda.desched_grid(500_000, 1, 8, True, 132) == 132 - 49
    assert cuda.desched_grid(200_000, 1, 8, True, 40) == 1
    rng = np.random.default_rng(9)
    for _ in range(300):
        N, Pc = int(rng.integers(1, 300_000)), int(rng.integers(1, 300_000))
        R, dev, sms = int(rng.integers(1, 9)), bool(rng.integers(0, 2)), int(rng.integers(60, 140))
        G = cuda.desched_grid(N, Pc, R, dev, sms)
        assert 1 <= G <= min(cuda.DESCHED_MAX_GRID, sms - cuda.desched_side_blocks(R, dev))
        assert G * cuda.DESCHED_THREADS >= max(N, Pc) or G == min(
            cuda.DESCHED_MAX_GRID, sms - cuda.desched_side_blocks(R, dev))


def test_desched_passes_count_the_spread():
    """The radix passes the bound counts: the node order over its scores'
    spread, the candidate orders over theirs plus the node rank's bits."""
    from koordinator_tpu_torch.core.lownodeload import LNLNodeArrays, LNLPodArrays, as_tensors

    nodes = as_tensors(LNLNodeArrays(
        usage=np.array([[0, 0], [500, 500], [1000, 1000]], dtype=np.int64),
        alloc=np.full((3, 2), 1000, dtype=np.int64), unschedulable=np.zeros(3, bool),
        valid=np.ones(3, bool)))
    pods = as_tensors(LNLPodArrays(node=np.array([0, 1, 2], dtype=np.int32),
                                   usage=np.array([[0, 0], [10, 10], [300, 300]], np.int64),
                                   removable=np.ones(3, bool)))
    w = torch.tensor([1, 1])
    # node scores 0..1000: 10 bits, 2 passes; candidate scores 0..300: 9
    # bits + 2 of the rank = 11: 2 passes each
    assert chip_smoke.desched_passes(nodes, pods, w) == (2, 4)


def test_band_passes_count_the_spread():
    """The passes ``pod_band_rank``'s bound counts (``band_passes``, the
    kernel's plan on the host): constant keys drop out, keys pack into one
    64-bit word while their spreads fit, and only the digits that vary
    over the pods are passed."""
    from koordinator_tpu_torch.core.deschedule import BandKeys

    def keys(prio, ct, evict=(0, 0, 0)):
        return BandKeys(*(torch.tensor(v, dtype=d) for v, d in (
            ((1, 1, 1), torch.int8), (prio, torch.int64), ((2, 2, 2), torch.int8),
            ((3, 3, 3), torch.int8), ((0, 0, 0), torch.int64), (evict, torch.int64),
            (ct, torch.float64))))

    assert chip_smoke.band_passes(keys((5, 5, 5), (1.0, 1.0, 1.0))) == (0, 0)
    # priority spread 300: 9 bits, two digits, both varying
    assert chip_smoke.band_passes(keys((0, 300, 7), (1.0, 1.0, -0.0 + 1.0))) == (1, 2)
    # -0.0 ties 0.0: the create times are constant
    assert chip_smoke.band_passes(keys((0, 1, 2), (0.0, -0.0, 0.0))) == (1, 1)
    # eviction costs spanning 64 bits take a word of their own
    assert chip_smoke.band_passes(keys((0, 1, 2), (0.0, 0.0, 0.0),
                                       (-(1 << 63), 0, (1 << 63) - 1)))[0] == 2


@pytest.mark.cuda
def test_band_cases_equal_plain(card):
    """``pod_band_rank`` on ``chip_smoke.band_cases``: one pod, every key
    constant, keys in one composite word, int64 extremes that do not fit
    one, ``-(1 << 63)`` negated, -0.0/NaN creation times, and the one-block
    limit less one, at it and one above, with and without usage; one
    launch a call."""
    before = cuda.KERNELS["pod_band_rank"].launches
    n = chip_smoke.check_band_cases(card)
    assert cuda.KERNELS["pod_band_rank"].launches == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("usage", [False, True])
def test_band_rank_at_32768(card, usage):
    """The cooperative launch at P = 32,768, ties on every key."""
    from koordinator_tpu_torch.core import deschedule as ds

    keys = chip_smoke.band_arrays(card, 32_768, 9, usage)
    assert torch.equal(ds.pod_band_rank(keys).cpu(), ds.pod_band_rank_plain(keys).cpu())


@pytest.mark.cuda
def test_placement_cases_equal_plain(card):
    """``placement`` on ``chip_smoke.placement_cases``: N below one tile and
    not a multiple of it, one node, duplicates, empty vocabularies, and
    column unions wider than one phase of shared memory; one launch a
    call."""
    before = cuda.KERNELS["placement"].launches
    n = chip_smoke.check_placement_cases(card)
    assert cuda.KERNELS["placement"].launches == before + n


def test_band_and_placement_cases_run_on_cpu_tensors():
    """The two kernels' edge cases on CPU tensors, where the wrappers take
    their plain versions (and ``placement`` still plans each call): the
    cases build and compare, and nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    assert chip_smoke.check_band_cases(cpu) == 5  # the launch-size cases are the card's
    assert chip_smoke.check_placement_cases(cpu) == 6
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


SHARD_CASES = 64  # chip_smoke.check_shard_cases: 8 blocks x 4 strategy shapes x 2
GATE_CASES = 45  # chip_smoke.check_gate_cases: 3 row counts x 3 bindings x 5 modes
# and its faults' launches (chip_smoke.gate_fault_cases): two calls for each
# of set_ and resize_, none for the refused strided rows
GATE_FAULT_LAUNCHES = 4


@pytest.mark.cuda
def test_shard_cases_equal_plain(card):
    """``shard_score_map`` blocks launched alone into sentinel buffers: at
    offsets 100 and 200 of N = 300 and a 53-column block inside one tile,
    P = 1 and P = 65 (a strip boundary), the generic instantiation (R = 3),
    the three strategies (RTC under two shapes), without and with extras;
    each equal to its plain version written alone the same way and to the
    unsharded ``score_batch`` at its columns, every other column kept."""
    before = cuda.KERNELS["shard_score_map"].launches
    assert chip_smoke.check_shard_cases(card) == SHARD_CASES
    assert cuda.KERNELS["shard_score_map"].launches == before + SHARD_CASES


@pytest.mark.cuda
def test_gate_cases_equal_plain(card):
    """``dstate_gate`` at N = 1, 257 and 1,001 in five expiry modes
    (180 with and without the filters following, None, 0, -5), bound to
    its rows, rebound to other rows and back, through the public entry and
    a ``GateStage`` of its own, bit for bit against its plain version;
    then strided rows refused and rows moved under the same tensors equal
    plain (``gate_fault_cases``)."""
    before = cuda.KERNELS["dstate_gate"].launches
    assert chip_smoke.check_gate_cases(card) == GATE_CASES
    assert cuda.KERNELS["dstate_gate"].launches == before + 2 * GATE_CASES + GATE_FAULT_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 257, 1001])  # one row's column is contiguous
def test_gate_refuses_strided_rows_and_follows_moved_ones(card, rows):
    """The public ``dstate_gate`` with its five gated rows as columns of
    [N, 3] tables raises ``ValueError`` before any launch (the kernel
    reads a row through its base pointer); a bound row moved to new
    storage with new values by ``set_`` or by a reallocating ``resize_``
    is gated anew, equal to the plain version on the new values."""
    before = cuda.KERNELS["dstate_gate"].launches
    got = chip_smoke.gate_fault_cases(card, rows)
    assert got["strided"].startswith("refused: gate input 3: expected a contiguous"), got
    assert got["set_"] == got["resize_"] == "equal", got
    assert cuda.KERNELS["dstate_gate"].launches == before + GATE_FAULT_LAUNCHES


def test_shard_and_gate_cases_run_on_cpu_tensors():
    """The two sets of cases on CPU tensors, where the wrappers take their
    plain versions: the cases build and compare, the sentinels hold, and
    nothing launches."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    cpu = torch.device("cpu")
    assert chip_smoke.check_shard_cases(cpu) == SHARD_CASES
    assert chip_smoke.check_gate_cases(cpu) == GATE_CASES
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


KOORDLET = ("shard_score_map", "aggregate_node_metrics")


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes,num_pods", [(500, 64), (300, 45)])
def test_koordlet_kernels_equal_plain(card, num_nodes, num_pods):
    """``shard_score_map`` at S = 1, 2 and 4 under the three strategies,
    with and without extras, against its plain version and the unsharded
    ``score`` kernel; ``aggregate_node_metrics`` at 64 x 64 with the edge
    rows and at 300 series x 33 samples, bit for bit."""
    from koordinator_tpu_torch.core import metricsagg as ma

    before = {k: cuda.KERNELS[k].launches for k in KOORDLET}
    chip_smoke.check_shard_kernels(_inputs(card, num_nodes, num_pods), (1, 2, 4), timed=False)
    chip_smoke.check_metricsagg_kernels(card, [("ragged", *chip_smoke.agg_series(card, 300, 33,
                                                                                  5))])
    assert all(cuda.KERNELS[k].launches > before[k] for k in KOORDLET)
    # the mean's NaN is the canonical one, the percentiles keep their payloads
    v, valid, t = chip_smoke.agg_series(card, 8, 16, 6)
    out = ma.aggregate_node_metrics(v, valid, t).cpu()
    assert out[0, 0].isnan() and out.view(torch.int64)[0, 0] == 0x7FF8000000000000


@pytest.mark.cuda
def test_koordlet_path_on_the_card(card):
    """``chip_smoke``'s koordlet path at 600 nodes on the card: every
    kernel of the path launches, the NodeMetrics equal the CPU twin's, the
    replies the twin's and the unsharded sidecar's, the mesh slice mode."""
    launches, rec, _ = chip_smoke.drive_koordlet_path(card, 600, 64, SCALARS)
    assert all(launches[k] for k in chip_smoke.KOORDLET_PATH_KERNELS), launches
    assert launches["shard_score_map"] == chip_smoke.KOORDLET_SHARDS


def test_koordlet_checks_run_on_cpu_tensors():
    """The koordlet slice's checks on CPU tensors, where both wrappers take
    their plain versions: the comparison logic itself, and no launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_shard_kernels(_inputs(torch.device("cpu"), 300, 40), (1, 2, 4), timed=False)
    chip_smoke.check_metricsagg_kernels(torch.device("cpu"), [
        ("ragged", *chip_smoke.agg_series(torch.device("cpu"), 300, 33, 5))])
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_koordlet_path_runs_on_cpu():
    """``chip_smoke``'s koordlet path at a small fleet on the CPU (the
    "card's" sidecar and producer on the CPU too): the NodeMetrics equal the
    twin's, every reply of the three sidecars agrees, the mesh equals slice
    mode, and nothing launches."""
    launches, rec, windows = chip_smoke.drive_koordlet_path(torch.device("cpu"), 300, 64,
                                                            SCALARS)
    assert not any(launches.values())
    assert [r["verb"] for r in rec["verbs"]][-1] == "SCHEDULE assume"
    assert all(rec["placed"].values())
    assert [w[0] for w in windows][-1] == "pod window 60 s"
    assert windows[0][1].shape == (600, chip_smoke.KOORDLET_TICKS)


def test_koordlet_wrappers_refuse_before_launch():
    """Bad block bounds, buffers and sample axes raise before any launch."""
    from koordinator_tpu_torch.core import metricsagg as ma
    from koordinator_tpu_torch.service import sharding as sh

    x = _inputs(torch.device("cpu"), 40, 10)
    P, N = x["la_pods"].est.shape[0], x["valid"].shape[0]
    args = (x["la_pods"], x["la_nodes"], x["weights"], x["nf_pods"], x["nf_nodes"], x["static"],
            x["valid"], None)
    t = torch.zeros((P, N), dtype=torch.int64)
    f = torch.zeros((P, N), dtype=torch.bool)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    with pytest.raises(ValueError, match="outside"):
        sh.shard_score_map(*args, 0, N + 1, t, f)
    with pytest.raises(ValueError, match="totals"):
        sh.shard_score_map(*args, 0, N, t[:, : N // 2], f)
    with pytest.raises(ValueError, match="feasible"):
        sh.shard_score_map(*args, 0, N, t, f.t().contiguous().t())
    meta = torch.device("meta")
    v, valid, times = (a.to(meta) for a in chip_smoke.agg_series(torch.device("cpu"), 8, 8, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ma.aggregate_node_metrics(v, valid, times)
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


@pytest.mark.cuda
def test_mesh_across_cards(card):
    """The mesh over ``cuda:0 .. cuda:3`` (the default devices), each block
    on a card of its own: the pod rows replicated, the block's node rows
    and extra scores copied over, four ``shard_score_map`` launches, each
    block copied back once; equal to slice mode and to the engine."""
    from koordinator_tpu_torch.api.model import Pod
    from koordinator_tpu_torch.core.deviceshare import GPUDevice
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.sharding import ShardedEngine
    from koordinator_tpu_torch.utils.fixtures import NOW

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    pods, nodes = random_cluster(9, num_nodes=600, num_pods=60)
    pods.append(Pod(name="gpu", requests={"cpu": 1000, "koordinator.sh/gpu-core": 100}))
    st = sm.ClusterState(extra_scalars=SCALARS)
    for n in nodes:
        st.upsert_node(n)
    for n in nodes[::50]:
        st.set_devices(n.name, [GPUDevice(minor=m) for m in range(2)])
    eng = Engine(st, device=card)
    mesh = ShardedEngine(st, 4, engine=eng, shard_map=True)
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    before = cuda.SHARD_SCORE_MAP.launches
    got = mesh.score(pods, now=NOW)
    assert cuda.SHARD_SCORE_MAP.launches - before == 4
    for want in (ShardedEngine(st, 4, engine=eng).score(pods, now=NOW), eng.score(pods, now=NOW)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].any() and not got[1].all()


@pytest.mark.cuda
def test_agg_cases_equal_plain(card):
    """``aggregate_node_metrics`` on ``chip_smoke.agg_cases``: T = 1, 33 and
    256 on the warp kernel (the compaction's boundaries, the full sort's
    valid 1e300, +inf and NaN), 257 and 2,048 on the block kernel, and
    store windows whose valid arc wraps the ring, bit for bit."""
    before = cuda.AGGREGATE_NODE_METRICS.launches
    chip_smoke.check_agg_cases(card)
    assert cuda.AGGREGATE_NODE_METRICS.launches == before + len(chip_smoke.agg_cases(card))


@pytest.mark.cuda
def test_scatter_cases_equal_plain(card):
    """``dstate_scatter`` on ``chip_smoke.scatter_cases``: rows of 1 to 56
    bytes, one row, duplicate padded indices, and three scatters issued
    back to back with no synchronise (the staging reused), against the
    plain version and ``index_copy_``."""
    before = cuda.DSTATE_SCATTER.launches
    chip_smoke.check_scatter_cases(card)
    assert cuda.DSTATE_SCATTER.launches == before + sum(
        len(b) for _, _, b in chip_smoke.scatter_cases())


def test_agg_and_scatter_cases_run_on_cpu_tensors():
    """The two kernels' edge-case checks on CPU tensors, where both
    wrappers take their plain versions: the comparison logic, and no
    launch."""
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    chip_smoke.check_agg_cases(torch.device("cpu"))
    chip_smoke.check_scatter_cases(torch.device("cpu"))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_agg_bound_counts_what_the_inputs_need():
    """Two series of three samples, three valid: 6 valid bytes, 16 bytes a
    valid sample, 48 bytes a series of output; no operations."""
    valid = torch.tensor([[True, False, True], [False, True, False]])
    ms, by = chip_smoke.agg_bound(valid)
    assert by == "bytes" and ms == (6 + 3 * 16 + 2 * 48) / chip_smoke.HBM_BYTES_PER_S * 1e3
