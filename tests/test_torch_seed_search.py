"""The port's device seed probe (``--device_probe``) against the JAX
package, exact arrays in the same order.

``sortmerna_tpu_torch.ops.seed_search.DeviceSeedSearcher`` on ``cpu`` runs
the plain versions ``seed_probe_plain`` and ``seed_compact_plain`` (what
the ``csrc/seed_probe.cu`` kernels are held against on the card); it must
return the JAX ``DeviceSeedSearcher``'s ``(window, id)`` arrays element
for element, on synthetic index parts at seed lengths 14, 18 and 22, for
random, real and mutated windows, with and without ``--full_search`` and
a ``minoccur`` gate, and on the probe edge inputs of
``testing.probe_edges`` (tables written slot by slot) against
``_probe_kernel`` itself.  The CLI with
``-device_probe`` must write the JAX CLI's reports byte for byte.  Inputs
come from numpy.random.default_rng(seed).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one intra-op
# thread each keeps torch's OpenMP pools from oversubscribing them
torch.set_num_threads(1)

from sortmerna_tpu import cli as jcli                       # noqa: E402
from sortmerna_tpu.index import builder as jbuilder         # noqa: E402
from sortmerna_tpu.index.hashtab import hash_u64            # noqa: E402
from sortmerna_tpu.ops import seed_math as jmath            # noqa: E402
from sortmerna_tpu.ops import seed_nfa as jnfa              # noqa: E402
from sortmerna_tpu.ops import seed_search as jss            # noqa: E402
from sortmerna_tpu_torch import cli as tcli                 # noqa: E402
from sortmerna_tpu_torch import testing                     # noqa: E402
from sortmerna_tpu_torch.engine import align as talign      # noqa: E402
from sortmerna_tpu_torch.index import builder as tbuilder   # noqa: E402
from sortmerna_tpu_torch.ops import seed_math as tmath      # noqa: E402
from sortmerna_tpu_torch.ops import seed_nfa as tnfa        # noqa: E402
from sortmerna_tpu_torch.ops import seed_search as tss      # noqa: E402

_CODE = np.full(256, 0, np.int64)
_CODE[list(b"ACGT")] = [0, 1, 2, 3]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    top = tmp_path_factory.mktemp("seed")
    db = str(top / "db.fasta")
    seqs = testing.make_db(db, 60, n_families=6, len_range=(1300, 1400),
                           seed=3)
    return db, seqs


_PARTS = {}


def _part(synth, L):
    if L not in _PARTS:
        _PARTS[L] = jbuilder.build_index(synth[0], seed_win_len=L).parts[0]
    return _PARTS[L]


def _windows(seqs, L, seed):
    """Real windows of reference sequences (every 3rd start, both
    strands), mutated copies with 1-3 point edits, and random ones."""
    pw = L // 2
    rng = np.random.default_rng(seed)
    weights = 4 ** np.arange(pw - 1, -1, -1)
    w1, w2 = [], []
    for s in seqs[:4]:
        e = _CODE[np.frombuffer(s, np.uint8)]
        for enc in (e, 3 - e[::-1]):
            for st in range(0, len(enc) - L + 1, 7):
                w = enc[st:st + L].copy()
                for _ in range(st % 4):       # 0-3 point edits
                    w[rng.integers(0, L)] = rng.integers(0, 4)
                w1.append(int(w[:pw] @ weights))
                w2.append(int(w[pw:] @ weights))
    rnd = rng.integers(0, 1 << (2 * pw), (2, 700))
    return (np.concatenate([w1, rnd[0]]).astype(np.int64),
            np.concatenate([w2, rnd[1]]).astype(np.int64))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", [14, 18, 22])
@pytest.mark.parametrize("full_search", [False, True])
@pytest.mark.parametrize("minoccur", [0, 2])
def test_searcher_matches_jax(synth, L, full_search, minoccur):
    part = _part(synth, L)
    w1, w2 = _windows(synth[1], L, seed=L + minoccur)
    want = jss.DeviceSeedSearcher(part, minoccur, full_search) \
        .search_windows(w1, w2)
    got = tss.DeviceSeedSearcher(part, minoccur, full_search,
                                 device="cpu").search_windows(w1, w2)
    _assert_same(got, want)
    assert len(want[0]) > 300
    # windows with several ids, and windows with none, were in the batch
    per = np.bincount(want[0], minlength=len(w1))
    assert per.max() > 1 and (per == 0).any()


def test_split_batches_match_jax(synth, monkeypatch):
    """Batches over MAX_WINDOWS split in halves with re-offset windows,
    at a batch size that is a multiple of nothing."""
    part = _part(synth, 18)
    w1, w2 = _windows(synth[1], 18, seed=5)
    w1, w2 = w1[:1237], w2[:1237]
    want = jss.DeviceSeedSearcher(part).search_windows(w1, w2)
    monkeypatch.setattr(tss.DeviceSeedSearcher, "MAX_WINDOWS", 100)
    got = tss.DeviceSeedSearcher(part, device="cpu").search_windows(w1, w2)
    _assert_same(got, want)


def test_cpu_tensors_take_the_plain_versions_without_counting(synth):
    s = tss.DeviceSeedSearcher(_part(synth, 18), device="cpu")
    w1, w2 = (torch.from_numpy(w).to(torch.int32)
              for w in _windows(synth[1], 18, seed=9))
    tss.reset_launches()
    count, ids = tss.seed_probe(s.tabs, w1, w2, 9, False, 0)
    want = tss.seed_probe_plain(s.tabs, w1.long(), w2.long(), 9, False, 0)
    assert torch.equal(count, want[0]) and torch.equal(ids, want[1])
    assert ids.shape == (len(w1), tss.ids_per_window(9)) == (len(w1), 439)
    win, got, total = tss.seed_compact(count, ids, 9)
    assert torch.equal(win, tss.seed_compact_plain(count, ids)[0])
    assert torch.equal(got, tss.seed_compact_plain(count, ids)[1])
    assert tss.LAUNCHES == {"seed_probe": 0, "seed_compact": 0}
    assert int(count.sum()) == len(got) == int(total[0]) > 300
    meta = {k: v.to("meta") for k, v in s.tabs.items()}
    with pytest.raises(ValueError, match="kernels run on cuda"):
        tss.seed_probe(meta, w1.to("meta"), w2.to("meta"), 9, False, 0)


def test_home_bits_cover_every_key(synth):
    """The home bitmap the kernel reads first: one bit for each home slot
    of a key (index/hashtab.hash_u64 of every key the table holds) and no
    other, so a key whose bit is clear is in no slot."""
    tabs = [tss.DeviceSeedSearcher(_part(synth, 18), device="cpu").tabs] \
        + [tss.with_home_bits({k: torch.from_numpy(v)
                               for k, v in c["tabs"].items()})
           for c in testing.probe_edges()]
    for t in tabs:
        for name in ("fx", "fp", "rx", "rp", "k19"):
            keys = t[name + "_keys"].numpy()
            size = len(keys)
            homes = np.unique(hash_u64(keys[keys != -1].view(np.uint64),
                                       size.bit_length() - 1))
            want = np.zeros((size + 31) // 32 * 32, bool)
            want[homes] = True
            words = t[name + "_home"].numpy().view(np.uint32)
            got = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            np.testing.assert_array_equal(got.ravel().astype(bool), want)


def test_hash_matches_hash_u64():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 52, 4000, dtype=np.int64)
    keys[:3] = [0, (1 << 52) - 1, (1 << 26) - 1]
    for bits in (4, 17, 24):
        got = tss.hash_keys(torch.from_numpy(keys), bits).numpy()
        np.testing.assert_array_equal(got, hash_u64(keys.view(np.uint64),
                                                    bits))


def test_out_of_range_windows_raise(synth):
    s = tss.DeviceSeedSearcher(_part(synth, 18), device="cpu")
    with pytest.raises(ValueError, match="packed 9-mers"):
        s.search_windows(np.array([1 << 18]), np.array([0]))
    w, i = s.search_windows(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert len(w) == len(i) == 0


def test_seed_math_copies_match():
    rng = np.random.default_rng(2)
    w10 = rng.integers(0, 1 << 20, 3000)
    p9 = rng.integers(0, 1 << 18, 3000)
    p9[::2] = w10[::2] >> 2             # near matches
    for a, b in zip(tmath.accept_tail(w10, p9), jmath.accept_tail(w10, p9)):
        np.testing.assert_array_equal(a, b)
    for p in (0, 12345, (1 << 18) - 1):
        for fn in ("sub_variants_packed", "del_variants_packed",
                   "ins_variants_packed", "ins9_variants_packed"):
            np.testing.assert_array_equal(getattr(tmath, fn)(p),
                                          getattr(jmath, fn)(p))
    for _ in range(200):
        w, p = list(rng.integers(0, 4, 10)), list(rng.integers(0, 4, 9))
        assert tnfa.accept_tail_nfa(w, p) == jnfa.accept_tail_nfa(w, p)


def test_caps_take_the_host_prober_with_a_warning(synth, capsys):
    """Only the caps' ValueError falls back; any other error raises."""
    part = tbuilder.build_index(synth[0]).parts[0]
    part.r_pref_count = part.r_pref_count.copy()
    part.r_pref_count[0] = tss.CAP_RDEL + 1
    opts = talign.Opts(device_probe=True)
    s = talign._make_searcher(part, opts, "cpu")
    assert type(s).__name__ == "SeedSearcher"
    assert "device probe unavailable" in capsys.readouterr().err
    part.r_pref_count[0] = 0
    assert isinstance(talign._make_searcher(part, opts, "cpu"),
                      tss.DeviceSeedSearcher)
    part._dev_searcher = None
    with pytest.raises(ValueError, match="unsupported device"):
        talign._make_searcher(part, opts, "meta")


def test_threads_build_one_searcher_a_part(synth, monkeypatch):
    """Read shards reach _make_searcher together: the second waits for
    the first's searcher (its tables on the device) and gets it, rather
    than building and uploading its own.  The first build is held until
    the second call has returned or 2 s have passed."""
    import threading
    part = tbuilder.build_index(synth[0]).parts[0]
    opts = talign.Opts(device_probe=True)
    building, second_back = threading.Event(), threading.Event()
    built = []

    class Slow(tss.DeviceSeedSearcher):
        def __init__(self, *a, **kw):
            built.append(1)
            building.set()
            second_back.wait(2)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tss, "DeviceSeedSearcher", Slow)
    got = {}

    def make(name, after=None):
        if after is not None:
            after.wait(60)
        got[name] = talign._make_searcher(part, opts, "cpu")
        if name == "second":
            second_back.set()

    ths = [threading.Thread(target=make, args=("first",)),
           threading.Thread(target=make, args=("second", building))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    assert not any(t.is_alive() for t in ths)
    assert built == [1]
    assert isinstance(got["first"], Slow) and got["second"] is got["first"]


def test_cli_device_probe_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs with -device_probe (the port on cpu: the plain probe and
    sw_fused_plain) write the same reports."""
    db = str(tmp_path / "db.fasta")
    reads = str(tmp_path / "reads.fasta")
    seqs = testing.make_db(db, 200, n_families=20, len_range=(1400, 1500),
                           seed=11)
    testing.make_reads(reads, seqs, 2000, seed=12)
    idx = tmp_path / "idx"
    idx.mkdir()
    (idx / ".keep").write_text("")

    def argv(wd):
        return ["-ref", db, "-reads", reads, "-device_probe"] \
            + testing.VERIFY_FLAGS \
            + ["-idx-dir", str(idx), "-workdir", str(tmp_path / wd)]

    assert jcli.main(argv("wd_jax")) == 0
    monkeypatch.setenv("SMR_TORCH_DEVICE", "cpu")
    calls = []
    orig = tss.seed_probe_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tss, "seed_probe_plain", spy)
    assert tcli.main(argv("wd_torch")) == 0
    assert calls
    got = {k: testing.read_outputs(str(tmp_path / f"wd_{k}" / "out"),
                                   [str(tmp_path / f"wd_{k}")])
           for k in ("jax", "torch")}
    assert len(got["jax"]) == 7
    for name in got["jax"]:
        assert got["torch"][name] == got["jax"][name], name
    assert got["torch"]["aligned.fa"].count(b">") > 500


def test_without_gpu_the_device_paths_raise(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    part = _part(synth, 18)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            tss.DeviceSeedSearcher(part, device=dev)
    reads = str(tmp_path / "reads.fasta")
    testing.make_reads(reads, synth[1], 10, seed=6)
    monkeypatch.delenv("SMR_TORCH_DEVICE", raising=False)
    for extra, env in ((["-device_probe"], {}), ([], {"SMR_PALLAS": "2"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="is_available"):
            tcli.main(["-ref", synth[0], "-reads", reads, "-workdir",
                       str(tmp_path / "wd")] + extra)


_EDGES = {c["name"]: c for c in testing.probe_edges()}


def _jax_tabs(tabs):
    """Edge tables in the JAX searcher's layout: keys split into uint32
    halves, uint32 values and counts."""
    out = {}
    for name in ("fx", "fp", "rx", "rp", "k19"):
        lo, hi = jss._split_keys_u64(tabs[name + "_keys"].view(np.uint64))
        out[name + "_lo"], out[name + "_hi"] = jnp.asarray(lo), \
            jnp.asarray(hi)
        out[name + "_val"] = jnp.asarray(tabs[name + "_val"].view(np.uint32))
    out["r_ids"] = jnp.asarray(tabs["r_ids"].view(np.uint32))
    out["kmer_counts"] = jnp.asarray(tabs["kmer_counts"].astype(np.uint32))
    return out


@pytest.mark.parametrize("name", sorted(_EDGES))
@pytest.mark.parametrize("full_search", [False, True])
def test_probe_edges_match_probe_kernel(name, full_search):
    """The plain versions, and the wrappers on cpu, against _probe_kernel
    on tables written slot by slot: chains at and past MAX_PROBES, chains
    that wrap or hold no EMPTY, groups at the caps, clamped r_ids starts,
    gates, modes, repeated and wrapped ids."""
    c = _EDGES[name]
    pw, nw = c["pw"], len(c["w1"])
    w1, w2 = c["w1"].astype(np.int32), c["w2"].astype(np.int32)
    cap = nw * tss.ids_per_window(pw)
    ow, oi, total = jss._probe_kernel(
        _jax_tabs(c["tabs"]), jnp.asarray(w1), jnp.asarray(w2),
        jnp.int32(nw), pw, full_search, c["minoccur"], cap)
    total = int(total)
    want = (np.asarray(ow[:total]), np.asarray(oi[:total]))
    tabs = {k: torch.from_numpy(v) for k, v in c["tabs"].items()}
    got = tss.probe_windows_plain(tabs, torch.from_numpy(c["w1"]),
                                  torch.from_numpy(c["w2"]), pw,
                                  full_search, c["minoccur"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    win, ids, n = tss.probe_windows(tabs, torch.from_numpy(w1),
                                    torch.from_numpy(w2), pw, full_search,
                                    c["minoccur"])
    assert int(n[0]) == total
    np.testing.assert_array_equal(win.numpy(), want[0])
    np.testing.assert_array_equal(ids.numpy(), want[1])
    pairs = set(zip(want[0].tolist(), want[1].tolist()))
    assert all(p in pairs for p in c["present"])
    assert not any(p in pairs for p in c["absent"])
    assert total > 50


def test_probe_edges_reach_their_sizes():
    """The groups case's windows collect 31, 32, 33, 64, 65, 128, 129 and
    376 ids before de-dup in the kernel's probe list (the register sort's
    sizes either side, and the most a window can hold at pw 9: 1 + 27 + 36
    + 28 F ids, 4 + 108 + 144 + 28 R ids, every probe found and every
    group at its cap); the tables hold the layouts the kernel must
    take."""
    c = _EDGES["groups"]
    tabs = {k: torch.from_numpy(v) for k, v in c["tabs"].items()}
    count, ids = tss.seed_probe_plain(tabs, torch.from_numpy(c["w1"]),
                                      torch.from_numpy(c["w2"]), 9, True, 2)
    # the windows' ids are distinct (no de-dup), so the unique count is
    # the collected count for the first seven
    assert count[:7].tolist() == [31, 32, 33, 64, 65, 128, 129]
    assert 128 < int(count[7]) <= 376
    full = _EDGES["full"]["tabs"]
    assert all((full[k + "_keys"] != -1).all() and len(full[k + "_keys"])
               == 16 for k in ("fx", "fp", "rx", "rp", "k19"))
    with pytest.raises(ValueError, match="power of two"):
        bad = dict(tabs, fx_keys=tabs["fx_keys"][:12].contiguous(),
                   fx_val=tabs["fx_val"][:12].contiguous())
        tss.seed_probe(bad, torch.from_numpy(c["w1"].astype(np.int32)),
                       torch.from_numpy(c["w2"].astype(np.int32)), 9, True,
                       2)
