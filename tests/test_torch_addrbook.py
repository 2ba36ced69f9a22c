"""The port's address book (``cometbft_tpu_torch/p2p/addrbook.py``)
against the JAX package's, on the CPU: the cases of
``tests/test_addrbook.py`` run through both books with the salt pinned
(set on the JAX book's ``_salt``, passed to the port's), the JAX book's
shuffles drawn from the module ``random`` seeded as the port book's
generator, and one fixed clock installed in both packages, so that the
same operations give the same buckets, the same picks and the same
file, byte for byte.  Each package loads the other's file (and the
legacy flat format), and the port's peer scorer records its timed bans
in the book as the JAX scorer does."""

import json
import random

import numpy as np
import pytest

from cometbft_tpu.libs import clock as jclock
from cometbft_tpu.p2p import addrbook as jab
from cometbft_tpu.p2p.quality import PeerScorer as JScorer
from cometbft_tpu_torch.libs import clock as pclock
from cometbft_tpu_torch.p2p import addrbook as pab
from cometbft_tpu_torch.p2p.quality import PeerScorer

pytestmark = pytest.mark.timeout(60)

SALT = "00c0ffee12345678"
T0 = 1_700_000_000.0


class _FixedClock:
    """One clock for both packages: wall time stands at ``t``."""

    def __init__(self):
        self.t = T0

    def monotonic(self) -> float:
        return self.t - T0

    def walltime_ns(self) -> int:
        return int(self.t * 1e9)


@pytest.fixture(autouse=True)
def fixed_clock():
    clk = _FixedClock()
    jclock.install(clk)
    pclock.install(clk)
    yield clk
    jclock.uninstall()
    pclock.uninstall()


def nid(i: int) -> str:
    return f"{i:040x}"


def make(pkg, path=None, seed=0):
    """A book of ``pkg`` ("jax" or "port") with the pinned salt; the
    JAX book's draws come from the module ``random``, seeded alike."""
    if pkg == "jax":
        random.seed(seed)
        b = jab.AddrBook(path)
        b._salt = SALT
        return b
    return pab.AddrBook(path, salt=SALT, rng=random.Random(seed))


def view(book) -> dict:
    """What a book holds: each id's tier and bucket, its entry, bans."""
    where = {k: list(v) for k, v in sorted(book._where.items())}
    entries = {}
    for tier in (book._new, book._old):
        for b in tier:
            for e in b.values():
                entries[e.node_id] = e.to_json()
    return {"where": where, "entries": entries, "banned": book.banned(),
            "old": book.num_old(), "new": book.num_new(),
            "size": book.size()}


def both(scenario, tmp_path):
    out = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        out.append(scenario(pkg, d))
    return out


def test_flood_cannot_evict_vetted_entries(tmp_path):
    """One source flooding 5,000 invented addresses evicts no old-tier
    entry and stays within its bucket share, in both books alike."""
    def scenario(pkg, d):
        book = make(pkg, str(d / "book.json"), seed=3)
        for i in range(40):
            assert book.add(nid(i), f"10.0.{i}.1:26656")
            book.mark_good(nid(i))
        added = [book.add(nid(10_000 + j),
                          f"203.0.{j % 256}.{j // 256}:26656",
                          persist=False, source="66.66.1.2:26656")
                 for j in range(5000)]
        assert book.num_old() == 40
        assert book.num_new() <= pab.BUCKETS_PER_SOURCE * pab.BUCKET_SIZE
        picked = book.pick(set(), n=20)
        assert {p for p, _ in picked} & {nid(i) for i in range(40)}
        book.save()
        return view(book), added, picked, (d / "book.json").read_bytes()

    j, p = both(scenario, tmp_path)
    assert j == p


def test_flood_from_many_sources_still_bounded_per_source(tmp_path):
    def scenario(pkg, d):
        book = make(pkg)
        for s in range(4):
            for j in range(3000):
                book.add(nid(s * 10_000 + j), f"198.{s}.{j % 250}.1:26656",
                         persist=False, source=f"4{s}.1.2.3:26656")
        assert book.num_new() <= 4 * pab.BUCKETS_PER_SOURCE * \
            pab.BUCKET_SIZE
        return view(book)

    j, p = both(scenario, tmp_path)
    assert j == p


def test_promotion_and_attempts(tmp_path):
    def scenario(pkg, d):
        book = make(pkg, str(d / "b.json"), seed=5)
        obs = [book.add(nid(1), "1.2.3.4:26656"), book.is_good(nid(1))]
        book.mark_good(nid(1))
        obs += [book.is_good(nid(1)),
                book.add(nid(1), "6.6.6.6:26656", source="9.9.9.9:1"),
                book.is_good(nid(1))]
        book.add(nid(2), "2.3.4.5:26656")
        for _ in range(pab.MAX_ATTEMPTS + 1):
            book.mark_attempt(nid(2))
        obs.append(book.pick({nid(1)}))
        for _ in range(pab.MAX_ATTEMPTS + 1):
            book.mark_attempt(nid(1))
        obs += [book.is_good(nid(1)),
                book.add(nid(1), "7.7.7.7:26656", source="8.8.8.8:1"),
                dict(book.pick(set(), n=5))]
        return obs, view(book)

    j, p = both(scenario, tmp_path)
    assert j == p
    assert j[0][:5] == [True, False, True, False, True]
    assert j[0][5] == [] and j[0][7] is True
    assert j[0][8][nid(1)] == "7.7.7.7:26656"


def test_persistence_round_trip_and_cross_load(tmp_path, fixed_clock):
    """The same operations write the same file; each package loads its
    own and the other's file to the same book (salt, tiers, bans)."""
    def scenario(pkg, d):
        path = str(d / "book.json")
        book = make(pkg, path)
        book.add(nid(1), "1.1.1.1:1")
        book.mark_good(nid(1))
        book.add(nid(2), "2.2.2.2:2", source="3.3.3.3:3")
        book.mark_bad(nid(9))
        book.mark_bad(nid(8), ttl=5.0)
        book.save()
        return (d / "book.json").read_bytes()

    jfile, pfile = both(scenario, tmp_path)
    assert jfile == pfile
    fixed_clock.t += 10.0          # nid(8)'s 5 s ban expires on load
    views = []
    for loader in ("jax", "port"):
        for src in ("jax", "port"):
            path = str(tmp_path / src / "book.json")
            book = (jab.AddrBook(path) if loader == "jax"
                    else pab.AddrBook(path))
            assert book._salt == SALT
            assert book.is_good(nid(1)) and book.size() == 2
            assert not book.add(nid(9), "9.9.9.9:9")     # ban persisted
            assert not book.is_banned(nid(8))
            views.append(view(book))
    assert all(v == views[0] for v in views)


def test_legacy_flat_format_import(tmp_path):
    path = str(tmp_path / "legacy.json")
    with open(path, "w") as f:
        json.dump({"salt": SALT,
                   "addrs": {nid(5): "5.5.5.5:5", nid(6): "6.6.6.6:6"},
                   "banned": [nid(7)]}, f)
    out = []
    for pkg in ("jax", "port"):
        book = jab.AddrBook(path) if pkg == "jax" else pab.AddrBook(path)
        assert book.size() == 2
        assert not book.is_banned(nid(7))       # a bare list has expired
        assert book.add(nid(7), "7.7.7.7:7", persist=False)
        out.append(view(book))
    assert out[0] == out[1]


def test_proven_address_replaces_stale_vetted_entry(tmp_path):
    def scenario(pkg, d):
        book = make(pkg, seed=9)
        book.add(nid(1), "1.1.1.1:26656")
        book.mark_good(nid(1))
        obs = [book.add(nid(1), "2.2.2.2:26656", source="9.9.9.9:1"),
               book.add(nid(1), "2.2.2.2:26656", proven=True),
               book.is_good(nid(1)), dict(book.sample(5))]
        return obs, view(book)

    j, p = both(scenario, tmp_path)
    assert j == p
    assert j[0][:3] == [False, True, True]
    assert j[0][3][nid(1)] == "2.2.2.2:26656"


def test_seeded_random_operations_match(tmp_path):
    """A seeded random stream of adds (hearsay and proven), successes,
    failures, bans, picks and samples over a few hundred ids and groups:
    every answer, the buckets and the saved file are equal."""
    rng = np.random.default_rng(20261018)
    ops = []
    for _ in range(3000):
        k = int(rng.integers(0, 8))
        i = int(rng.integers(0, 400))
        addr = (f"{int(rng.integers(1, 12))}.{int(rng.integers(0, 4))}."
                f"{int(rng.integers(0, 256))}.1:{int(rng.integers(1, 9))}")
        src = f"{int(rng.integers(20, 26))}.7.0.1:9"
        ops.append((k, i, addr, src, int(rng.integers(1, 40))))

    def scenario(pkg, d):
        book = make(pkg, str(d / "book.json"), seed=77)
        answers = []
        for k, i, addr, src, n in ops:
            if k <= 2:
                answers.append(book.add(nid(i), addr, persist=False,
                                        source=src))
            elif k == 3:
                answers.append(book.add(nid(i), addr, persist=False,
                                        proven=True))
            elif k == 4:
                book.mark_good(nid(i))
            elif k == 5:
                book.mark_attempt(nid(i))
            elif k == 6:
                if i % 13 == 0:
                    book.mark_bad(nid(i), ttl=float(n))
                answers.append(book.pick({nid(i)}, n=n % 7))
            else:
                answers.append(book.sample(n))
        book.save()
        return answers, view(book), (d / "book.json").read_bytes()

    j, p = both(scenario, tmp_path)
    assert j == p


def test_scorer_records_bans_in_the_book(tmp_path, fixed_clock):
    """A scorer with a book bans through it (persisted, timed), as the
    JAX scorer does: same verdicts, same book, same snapshot."""
    def scenario(pkg, d):
        book = make(pkg, str(d / "book.json"))
        sc = (JScorer(book, ban_ttl_s=30.0) if pkg == "jax"
              else PeerScorer(book, ban_ttl_s=30.0))
        actions = [sc.report(nid(3), "bad_block") for _ in range(3)]
        obs = [actions, sc.is_banned(nid(3)), book.is_banned(nid(3)),
               sc.bans_snapshot()]
        fixed_clock.t += 31.0
        obs += [sc.is_banned(nid(3)), book.is_banned(nid(3))]
        fixed_clock.t -= 31.0
        book.save()
        return obs, (d / "book.json").read_bytes()

    j, p = both(scenario, tmp_path)
    assert j == p
    assert j[0][1] and j[0][2] and not j[0][4]
