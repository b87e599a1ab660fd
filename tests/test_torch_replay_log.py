"""A whole log as one captured replay (models/captured.Captured) on the CPU.

`replay_jit` / `replay_surface_jit` of every engine, and a distributed
engine's `MeshStep.replay_jit` at mesh (1, 1) (gloo, in this process), run
the static-buffer loop that the card captures as one CUDA graph a log (on
the CPU the scans are called where the card replays the graph), with the
scans' draws made inside it from the replay's own generator, the caller's
generator state handed to it before and back after.  Each case holds:

- the eager `replay`'s bits in every state and info field, and the
  caller's generator after the call giving the same next draw as after the
  eager replay (the default generator too, where the caller gives none);
- a shorter log, a longer one, then the first length again, each with the
  eager bits, the static buffers kept while a log fits them and made anew,
  of the longer length, when one does not;
- injected stacked draws (the generator's own draws, stacked) giving the
  bits of the generator's replay, and leaving the caller's generator as it
  was;
- a log longer than CHUNK_SCANS (made small here) replayed in chunks of
  CHUNK_SCANS scans and the rest, with the eager bits and the generator's
  next draw, its draws drawn or injected.

The graphs themselves, one launch a chunk of a replay call, are held on
the card by chip_smoke.py's `captured` phase.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gridmap_slam_tpu_torch.models import captured
from gridmap_slam_tpu_torch.models.captured import tree_map
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from tests import test_torch_parallel_captured as tpc
from tests.test_torch_replay import Case, multi_logs, small_log  # noqa: F401

torch.set_num_threads(1)

ENGINES = ["rbpf", "blocked", "surface", "surface_inject_refine", "multi"]
MESH = ["mesh_shmap", "mesh_shmap_surface"]
SHORT = 2


class LogCase:
    """One replay under test: its eager replay, its captured one (a new
    one a call of jit()), one scan's draws from a generator, the start
    state and the stacked frames."""

    def __init__(self, name, small_log, multi_logs, world):
        if name in MESH:
            kind = name[len("mesh_"):]
            eng, self.frames, _ = tpc._setup(kind)
            step = tpc._make(kind, eng, world, jit=False)
            self.replay, self.jit = step.replay, step.replay_jit
            self.draw, self.init = step._draw, eng.init
            return
        case = Case(name, small_log, multi_logs)
        self.replay, self.jit = case.replay, case.jit
        self.frames, self.init = case.frames, case.init
        self.draw = (case.eng._draws if name in ("rbpf", "multi")
                     else case.eng._draw)


@pytest.fixture(scope="module")
def world():
    pmesh.init_world("cpu")
    return pmesh.make_mesh(device="cpu")


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _first(frames, n):
    return tree_map(lambda x: x[:n], frames)


def _assert_same(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _eager(case, n, seed=3):
    """The eager replay of the first n scans and its generator's next
    draw."""
    g = _gen(seed)
    st, infos = case.replay(case.init(), _first(case.frames, n), g)
    return st, infos, torch.randn(4, generator=g)


@pytest.mark.parametrize("name", ENGINES + MESH)
def test_replay_jit_is_the_eager_replay(small_log, multi_logs, world,
                                        name):
    """Every bit of the state and the infos, and the generator's next
    draw after the call."""
    case = LogCase(name, small_log, multi_logs, world)
    n = case.frames.t.shape[0]
    st_e, inf_e, next_e = _eager(case, n)
    fn = case.jit()
    g = _gen()
    st_c, inf_c = fn(case.init(), case.frames, g)
    _assert_same(st_e, st_c)
    _assert_same(inf_e, inf_c)
    assert torch.equal(torch.randn(4, generator=g), next_e)
    cap = fn.captured
    assert cap.scans == n and cap.capacity == n
    assert cap.graph is None and cap.graphs == {} and cap.captures == 0


@pytest.mark.parametrize("name", ["rbpf", "surface_inject_refine", "multi",
                                  "mesh_shmap"])
def test_default_generator_is_handed_over(small_log, multi_logs, world,
                                          name):
    """With no generator both replays draw from the default one, and leave
    it at the same place."""
    case = LogCase(name, small_log, multi_logs, world)
    with torch.random.fork_rng():
        torch.manual_seed(11)
        st_e, inf_e = case.replay(case.init(), case.frames)
        next_e = torch.randn(4)
        torch.manual_seed(11)
        st_c, inf_c = case.jit()(case.init(), case.frames)
        next_c = torch.randn(4)
    _assert_same(st_e, st_c)
    _assert_same(inf_e, inf_c)
    assert torch.equal(next_c, next_e)


@pytest.mark.parametrize("name", ENGINES + MESH)
def test_logs_of_other_lengths(small_log, multi_logs, world, name):
    """A shorter log, a longer one, then the first length again: each the
    eager bits and the generator's next draw; the buffers kept while a log
    fits them, made anew (of the longer length) when one does not."""
    case = LogCase(name, small_log, multi_logs, world)
    n = case.frames.t.shape[0]
    fn = case.jit()
    cap = fn.captured
    seen = []
    for k, seed in ((SHORT, 5), (n, 6), (SHORT, 7)):
        st_e, inf_e, next_e = _eager(case, k, seed)
        g = _gen(seed)
        st_c, inf_c = fn(case.init(), _first(case.frames, k), g)
        _assert_same(st_e, st_c)
        _assert_same(inf_e, inf_c)
        assert torch.equal(torch.randn(4, generator=g), next_e)
        assert inf_c.neff.shape[0] == k and cap.scans == k
        seen.append((cap.capacity, cap.state.poses))
    assert [c for c, _ in seen] == [SHORT, n, n]
    assert seen[1][1] is not seen[0][1]      # new buffers for the longer
    assert seen[2][1] is seen[1][1]          # kept for the shorter


@pytest.mark.parametrize("name", ENGINES + MESH)
def test_injected_draws_are_the_generator_s(small_log, multi_logs, world,
                                            name):
    """Stacked draws injected (read at the scan counter) give the bits of
    the replay that draws them from the generator, and leave the caller's
    generator untouched; the same captured replay then draws again."""
    case = LogCase(name, small_log, multi_logs, world)
    n = case.frames.t.shape[0]
    fn = case.jit()
    g = _gen()
    draws = tree_map(lambda *xs: torch.stack(xs),
                     *[case.draw(g) for _ in range(n)])
    st_e, inf_e, _ = _eager(case, n)
    other = _gen(99)
    st_d, inf_d = fn(case.init(), case.frames, other, draws=draws)
    _assert_same(st_e, st_d)
    _assert_same(inf_e, inf_d)
    assert torch.equal(other.get_state(), _gen(99).get_state())
    g = _gen()
    st_c, inf_c = fn(case.init(), case.frames, g)
    _assert_same(st_e, st_c)
    _assert_same(inf_e, inf_c)


def test_a_graph_holds_at_most_16_scans():
    assert captured.CHUNK_SCANS == 16
    assert captured.chunks(16) == [(0, 16)]
    assert captured.chunks(40) == [(0, 16), (16, 16), (32, 8)]
    assert len(captured.chunks(216)) == 14


@pytest.mark.parametrize("name", ENGINES + MESH)
def test_long_logs_are_replayed_in_chunks(small_log, multi_logs, world,
                                          monkeypatch, name):
    """With chunks of 3 scans, logs of 2, 3, 4 scans and the whole log (8
    scans; 6 for multi and the mesh steps): the eager bits and the
    generator's next draw, ceil(n / 3) chunks, buffers of min(n, 3) scans;
    then the whole log's draws injected, stacked."""
    monkeypatch.setattr(captured, "CHUNK_SCANS", 3)
    case = LogCase(name, small_log, multi_logs, world)
    n = case.frames.t.shape[0]
    assert n in (6, 8)
    fn = case.jit()
    cap = fn.captured
    for k, seed in ((2, 5), (3, 6), (4, 7), (n, 8)):
        st_e, inf_e, next_e = _eager(case, k, seed)
        g = _gen(seed)
        st_c, inf_c = fn(case.init(), _first(case.frames, k), g)
        _assert_same(st_e, st_c)
        _assert_same(inf_e, inf_c)
        assert torch.equal(torch.randn(4, generator=g), next_e)
        assert cap.launches == -(-k // 3) and cap.scans == min(k, 3)
        assert cap.capacity == min(k, 3)
    g = _gen()
    draws = tree_map(lambda *xs: torch.stack(xs),
                     *[case.draw(g) for _ in range(n)])
    st_e, inf_e, _ = _eager(case, n)
    other = _gen(99)
    st_d, inf_d = fn(case.init(), case.frames, other, draws=draws)
    _assert_same(st_e, st_d)
    _assert_same(inf_e, inf_d)
    assert torch.equal(other.get_state(), _gen(99).get_state())
    assert cap.launches == -(-n // 3)
