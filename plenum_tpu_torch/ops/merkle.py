"""Device-resident Merkle tree: the proof and append engine behind the
ledger's CompactMerkleTree.

Port of plenum_tpu/ops/merkle.py (`DeviceMerkleTree`, `ProofPipeline`) on
one CUDA device. The tree's node hashes live on the card as ONE uint8
buffer of 2 * cap - 1 rows of 32 big-endian bytes, cap the tree's
power-of-two capacity; level h (cap >> h rows, leaves at h = 0) starts at
row 2 * cap - 2 * (cap >> h), so the levels lie one after another as
sha256_node_levels writes them and a proof's sibling rows are plain row
indices into one tensor.

- `build` hashes the leaves (RFC 6962 prefix 0x00) with sha256_ragged
  straight into level 0 and every level above with sha256_node_levels, in
  place: no trip to the host between them. `build_from_leaf_hashes` (the
  resync path from a hash store) uploads the leaf digests and runs the
  levels alone.
- `append_leaf_hashes` writes new leaf digests into level 0 and hashes
  the new parents of `fused_levels` levels per sha256_append_levels
  launch (csrc/sha256.cu), all of an append's launches enqueued by one
  call (sha256_append_groups), so an append costs 1 + ceil(levels / K)
  dispatches. Complete nodes are immutable, so capacity growth copies
  the levels into a buffer twice the size and keeps the host mirrors.
- `dispatch_proof_batch` / `collect_proof_batch` serve RFC 6962
  inclusion proofs for any tree size (ragged included): the bottom levels'
  siblings are one index_select over [k, g] row indices, copied into
  pinned memory without blocking; the top levels (at most _TOP_CACHE
  nodes each) are mirrored on the host, so a batch downloads only the
  gathered rows. `ProofPipeline` keeps `depth` gathers in flight, so the
  next gather overlaps the current collect.

The JAX package's mesh branches are here (ops/mesh.py). A build whose
capacity clears the mesh gate and divides over the devices splits its
leaves into one contiguous subtree a device: each shard hashes its leaves
and builds its subtree's levels, the levels land in the tree's buffer on
its device, and the top log2(devices) levels are built there; the buffer
is byte-equal to an unsharded build's. A proof gather that clears the
gate splits its indices over the devices, each gathering from a copy of
the bottom levels on its device (the tree's own buffer on the tree's
device; copies memoized as snapshots, counted in
dispatch_stats["replica_broadcasts"]).

A CUDA tensor goes through the kernels, a CPU tensor (device="cpu")
through their plain versions; a failing launch raises, there is no step
down to the host. The JAX package's Pallas step-down chain has no
counterpart here.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.observability.tracing import CAT_DEVICE, NullTracer
from plenum_tpu_torch.ops import mesh as mesh_mod
from plenum_tpu_torch.ops import resolve_device, to_tensor
from plenum_tpu_torch.ops import sha256 as sha


def append_groups(n0: int, n1: int, k: int
                  ) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
    """The sha256_append_levels launches of an append of n0 → n1 leaves,
    up to k levels each: [(child level, [(level, p0, cnt)])], the new
    parents p0 .. p0 + cnt - 1 of each level, lowest level first."""
    out, h = [], 0
    while True:
        group = []
        while len(group) < k:
            level = h + len(group) + 1
            p0 = n0 >> level
            cnt = (n1 >> level) - p0
            if cnt == 0:
                break
            group.append((level, p0, cnt))
        if not group:
            return out
        out.append((h, group))
        h += len(group)


class DeviceMerkleTree:
    """An RFC 6962 tree whose node hashes live in device memory.

    Supports ANY size (ragged included) for builds, incremental appends
    and inclusion-proof batches. Complete nodes are immutable, so the
    levels only ever grow; capacity doubles like a vector."""

    # levels of at most this many nodes are mirrored to the host (lazily,
    # on the first proof batch, then kept fresh by appends), so a proof
    # batch gathers only the large bottom levels on the card
    _TOP_CACHE = 262144

    def __init__(self, hasher=None, device=None, fused_levels: int = None):
        """`device`: where the levels live and the kernels run (None means
        CUDA and raises without a card; "cpu" runs the plain versions).
        `fused_levels`: tree levels per append launch (the node's
        MERKLE_FUSED_LEVELS; None takes the Config default)."""
        from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
        self.device = resolve_device(device)
        self.hasher = hasher or TreeHasher()
        if fused_levels is None:
            fused_levels = Config.MERKLE_FUSED_LEVELS
        self.fused_levels = min(max(1, int(fused_levels)),
                                sha.APPEND_LEVELS_MAX)
        self._buf: Optional[torch.Tensor] = None   # [2 * cap - 1, 32] u8
        self._views, self._views_of = [], None     # _level's views of _buf
        self._size = 0
        self._cap = 0
        self._mirror = {}          # height -> host uint8 [cap >> h, 32]
        self._mirror_count = {}    # height -> mirrored complete prefix
        self._froot_cache = {}     # proof size n -> frontier root bytes
        # the bottom levels' copies on other devices for sharded gathers:
        # (buffer, levels, complete leaves at the copy, {device: rows})
        self._replicas = None
        self._staging = sha.PinnedStaging() \
            if self.device.type == "cuda" else None
        self.tracer = NullTracer()
        # cumulative device-IO counters (never reset with the tree), so
        # that "no re-materialization" is assertable without a tracer
        self.dispatch_stats = {
            "build_dispatches": 0,        # builds launched
            "append_dispatches": 0,       # leaf placements + level groups
            "gather_dispatches": 0,       # per-proof-batch low gathers
            "mirror_level_downloads": 0,  # full-level host downloads
            "mirror_rows_downloaded": 0,
            "row_reads": 0,               # single-row device reads
            "replica_broadcasts": 0,      # mesh copies of a low level
        }

    def attach_tracer(self, tracer) -> None:
        """Feed this tree's dispatch spans to a flight recorder (the
        serving ProofPipeline carries its own tracer; this one covers
        builds, appends and mirror downloads)."""
        self.tracer = tracer or NullTracer()

    # ------------------------------------------------------------ state

    @property
    def tree_size(self) -> int:
        return self._size

    def reset(self):
        self._buf, self._size, self._cap = None, 0, 0
        self._mirror, self._mirror_count, self._froot_cache = {}, {}, {}
        self._replicas = None

    def _depth(self) -> int:
        return self._cap.bit_length() - 1 if self._cap else 0

    def _offset(self, h: int, cap: int = None) -> int:
        """First row of level h in a buffer of capacity `cap` (this tree's
        by default)."""
        cap = self._cap if cap is None else cap
        return 2 * cap - 2 * (cap >> h)

    def _level(self, h: int) -> torch.Tensor:
        """Level h as a [cap >> h, 32] view of the buffer (the views made
        once per buffer: an append hands every level to the kernel)."""
        if self._views_of is not self._buf:
            self._views = [self._buf[self._offset(k):self._offset(k)
                                     + (self._cap >> k)]
                           for k in range(self._depth() + 1)]
            self._views_of = self._buf
        return self._views[h]

    def _n_low(self) -> int:
        """First host-mirrored height; heights below it are gathered on
        the device per proof batch."""
        h = 0
        while h < self._depth() and (self._cap >> h) > self._TOP_CACHE:
            h += 1
        return h

    def _invalidate(self):
        self._froot_cache = {}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A contiguous numpy array → a tensor of its dtype and shape on
        the device (on CUDA one copy from the pinned staging buffer,
        without blocking)."""
        arr = np.ascontiguousarray(arr)
        if self._staging is None:
            return torch.from_numpy(arr.copy())
        raw = self._staging.upload([arr.reshape(-1).view(np.uint8)],
                                   self.device)
        return raw.view(getattr(torch, arr.dtype.name)).view(arr.shape)

    def _new_buffer(self, cap: int) -> torch.Tensor:
        return torch.zeros((2 * cap - 1, 32), dtype=torch.uint8,
                           device=self.device)

    # ----------------------------------------------------------- builds

    def _adopt(self, buf: torch.Tensor, n: int, cap: int):
        """Make `buf` (levels 0..log2(cap) above n leaves) the tree's."""
        self._buf, self._size, self._cap = buf, n, cap
        self._mirror, self._mirror_count, self._froot_cache = {}, {}, {}
        self._replicas = None
        self.dispatch_stats["build_dispatches"] += 1

    def _shard_build(self, cap: int, n: int) -> bool:
        """Whether a build of capacity `cap` shards over the mesh: the
        gate passes and the capacity divides over the devices (a tree
        smaller than the device count stays on one device); a build that
        does not is counted as a passthrough."""
        m = mesh_mod.get_mesh()
        if m.should_shard(cap, self.device) and cap % m.n_devices == 0:
            return True
        m.note_passthrough(cap)
        return False

    def _build_sharded(self, cap: int, n: int, leaves=None,
                       digests=None) -> torch.Tensor:
        """The levels of a size-n tree of capacity `cap`, one contiguous
        subtree of cap / d leaves per mesh device: each shard hashes its
        leaves (`leaves`, raw) or takes their digests (`digests`, uint8
        [n, 32]) and builds its subtree's levels on its device; the levels
        are copied into a new buffer on the tree's device, where the top
        log2(d) levels are built. Leaf rows past n stay zero, as in an
        unsharded build, so the buffer is byte-equal to one."""
        m = mesh_mod.get_mesh()
        d = m.n_devices
        per = cap // d
        sub = per.bit_length() - 1          # levels inside a shard

        def shard_levels(dev, lo):
            real = max(0, min(n, lo + per) - lo)
            sbuf = torch.zeros((2 * per - 1, 32), dtype=torch.uint8,
                               device=dev)
            launch = None
            if real and leaves is not None:
                data, offsets = sha.upload_ragged(leaves[lo:lo + real], dev)
                launch = sha.sha256_ragged(data, offsets, 0x00,
                                           out=sbuf[:real])
            elif real:
                sbuf[:real].copy_(to_tensor(digests[lo:lo + real], dev))
            if sub:
                sha.sha256_node_levels(sbuf[:per], sub, out=sbuf[per:])
            return sbuf, launch

        shards = m.dispatch(
            shard_levels, [np.arange(cap, dtype=np.int64)], n=cap,
            label="merkle_build",
            place=lambda shard, dev: (dev, int(shard[0][0])))
        buf = self._new_buffer(cap)
        for i, (sbuf, launch) in enumerate(shards):
            if isinstance(launch, sha.Sha256Launch):
                launch.host()       # raises if the kernel flagged offsets
            for h in range(sub + 1):
                rows = per >> h
                src = 2 * per - 2 * rows
                dst = self._offset(h, cap) + i * rows
                buf[dst:dst + rows].copy_(sbuf[src:src + rows])
        if d > 1:
            top = self._offset(sub, cap)
            sha.sha256_node_levels(buf[top:top + d], d.bit_length() - 1,
                                   out=buf[top + d:])
        return buf

    def build(self, leaves: Sequence[bytes]) -> bytes:
        """Hash `leaves` and every level above them on the device; → root.
        sha256_ragged writes the leaf digests into level 0 and
        sha256_node_levels the levels above, in place."""
        n = len(leaves)
        if n == 0:
            self.reset()
            return self.hasher.hash_empty()
        cap = mesh_mod.pow2_at_least(n)
        depth = cap.bit_length() - 1
        if self._shard_build(cap, n):
            with self.tracer.span("merkle_build_dispatch", CAT_DEVICE,
                                  n=cap):
                buf = self._build_sharded(cap, n, leaves=leaves)
            self._adopt(buf, n, cap)
            return self.root_hash
        with self.tracer.span("merkle_build_dispatch", CAT_DEVICE, n=cap):
            buf = self._new_buffer(cap)
            data, offsets = sha.upload_ragged(leaves, self.device,
                                              staging=self._staging)
            launch = sha.sha256_ragged(data, offsets, 0x00, out=buf[:n])
            if depth:
                sha.sha256_node_levels(buf[:cap], depth, out=buf[cap:])
        if isinstance(launch, sha.Sha256Launch):
            launch.host()           # raises if the kernel flagged offsets
        self._adopt(buf, n, cap)
        return self.root_hash

    def build_from_leaf_hashes(self, digests) -> bytes:
        """Build the device levels from precomputed RFC 6962 LEAF DIGESTS
        (a list of 32-byte bytes or uint8 [n, 32]): the resync path from a
        hash store. One upload, then the levels in place."""
        arr = self._digest_rows(digests)
        n = arr.shape[0]
        if n == 0:
            self.reset()
            return self.hasher.hash_empty()
        cap = mesh_mod.pow2_at_least(n)
        depth = cap.bit_length() - 1
        with self.tracer.span("merkle_build_dispatch", CAT_DEVICE, n=cap):
            if self._shard_build(cap, n):
                buf = self._build_sharded(cap, n, digests=arr)
            else:
                buf = self._new_buffer(cap)
                buf[:n].copy_(self._upload(arr))
                if depth:
                    sha.sha256_node_levels(buf[:cap], depth, out=buf[cap:])
        self._adopt(buf, n, cap)
        return self.root_hash

    def load_levels(self, rows: np.ndarray, size: int) -> bytes:
        """Take a tree's node hashes as they are, hashing nothing: `rows`
        uint8 [2 * cap - 1, 32] in this class's layout (level h at row
        2 * cap - 2 * (cap >> h)), `size` its leaves (0 < size <= cap). →
        root."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        cap = (rows.shape[0] + 1) // 2
        if rows.ndim != 2 or rows.shape[1] != 32 or cap & (cap - 1) \
                or rows.shape[0] != 2 * cap - 1 or not 0 < size <= cap:
            raise ValueError("expected [2 * cap - 1, 32] rows for a "
                             "power-of-two cap of at least {} leaves, got "
                             "{}".format(size, rows.shape))
        buf = self._new_buffer(cap)
        buf.copy_(self._upload(rows))
        self._adopt(buf, size, cap)
        return self.root_hash

    @staticmethod
    def _digest_rows(digests) -> np.ndarray:
        if isinstance(digests, np.ndarray):
            return np.ascontiguousarray(digests, dtype=np.uint8) \
                .reshape(-1, 32)
        return np.frombuffer(b"".join(digests), dtype=np.uint8) \
            .reshape(-1, 32).copy()

    # ------------------------------------------------ incremental append

    def _ensure_capacity(self, n: int):
        if self._buf is None:
            self._cap = mesh_mod.pow2_at_least(max(n, 1))
            self._buf = self._new_buffer(self._cap)
            self._mirror, self._mirror_count = {}, {}
            return
        if n <= self._cap:
            return
        new_cap = self._cap
        while new_cap < n:
            new_cap *= 2
        buf = self._new_buffer(new_cap)
        for h in range(self._depth() + 1):
            o = self._offset(h, new_cap)
            buf[o:o + (self._cap >> h)] = self._level(h)
        self._buf, self._cap = buf, new_cap
        # complete node rows are immutable, so growth keeps the host
        # mirrors: each kept level's array grows (zero rows for nodes not
        # yet complete) with its mirrored-prefix count; levels that fall
        # below the new _n_low() move to the per-batch device gather
        n_low = self._n_low()
        for h in list(self._mirror):
            if h < n_low:
                del self._mirror[h]
                self._mirror_count.pop(h, None)
                continue
            rows = new_cap >> h
            old = self._mirror[h]
            if old.shape[0] < rows:
                grown = np.zeros((rows, 32), dtype=np.uint8)
                grown[:old.shape[0]] = old
                self._mirror[h] = grown

    def append_leaf_hashes(self, digests, return_nodes: bool = False):
        """Append leaf DIGESTS: ~2b device hashes for b leaves, no rebuild.
        The leaves go into level 0 in one copy; the new parents of
        fused_levels levels are hashed per sha256_append_levels launch,
        every launch enqueued by one sha256_append_groups call (on the
        CPU, the plain version group by group), so an append costs 1 +
        ceil(levels / K) dispatches, each a flight-recorder record.

        With return_nodes=True, returns [(height, first_node_index,
        uint8 [cnt, 32])] for every newly COMPLETE node: exactly the
        (start, height) entries a CompactMerkleTree hash store persists
        for the same append (one download for all of them)."""
        arr = self._digest_rows(digests)
        b = arr.shape[0]
        if b == 0:
            return [] if return_nodes else None
        n0 = self._size
        n1 = n0 + b
        self._ensure_capacity(n1)
        with self.tracer.span("merkle_append_dispatch", CAT_DEVICE,
                              levels=0, n=b):
            self._level(0)[n0:n1].copy_(self._upload(arr))
        self.dispatch_stats["append_dispatches"] += 1
        news = [(0, n0, b)]
        groups = append_groups(n0, n1, self.fused_levels)
        news.extend(w for _, group in groups for w in group)
        if groups:
            launches = sha.sha256_append_groups(
                self._level(0), [self._level(h) for h, _, _ in news[1:]],
                [(p0, cnt) for _, p0, cnt in news[1:]], self.fused_levels)
            self.dispatch_stats["append_dispatches"] += launches
            # one record per launch, enqueued by the one call above
            at = 1
            for lv in sha.append_launches([len(g) for _, g in groups]):
                self.tracer.instant("merkle_append_dispatch", CAT_DEVICE,
                                    levels=lv, n=news[at][2])
                at += lv
        self._size = n1
        self._invalidate()
        wanted = [(height, pos, cnt) for height, pos, cnt in news
                  if return_nodes or height in self._mirror]
        rows_of = self._download_nodes([w for w in wanted if w[0] > 0])
        rows_of[0] = arr
        out = []
        for height, pos, cnt in wanted:
            rows = rows_of[height]
            if height in self._mirror \
                    and self._mirror_count.get(height, 0) == pos:
                self._mirror[height][pos:pos + cnt] = rows
                self._mirror_count[height] = pos + cnt
            if return_nodes:
                out.append((height, pos, rows))
        return out if return_nodes else None

    def _download_nodes(self, spans) -> dict:
        """[(height, first, count)] node spans → {height: uint8 [count, 32]}
        in one gather and one download."""
        if not spans:
            return {}
        rows = np.concatenate([np.arange(self._offset(h) + p,
                                         self._offset(h) + p + c)
                               for h, p, c in spans])
        flat = sha.Download(self._buf.index_select(
            0, self._upload(rows))).wait()
        out, at = {}, 0
        for h, _, c in spans:
            out[h] = flat[at:at + c]
            at += c
        return out

    # ---------------------------------------------------------- mirrors

    def _ensure_mirrors(self):
        """Materialize or refresh the host mirror of every top level (at
        most _TOP_CACHE nodes): one download of the levels from the lowest
        stale one up after a build or growth; appends keep the mirror
        fresh after that."""
        stale = [h for h in range(self._n_low(), self._depth() + 1)
                 if h not in self._mirror
                 or self._mirror_count.get(h, 0) < self._size >> h]
        if not stale:
            return
        lo = self._offset(stale[0])
        with self.tracer.span("merkle_mirror_download", CAT_DEVICE,
                              height=stale[0], rows=self._buf.shape[0] - lo):
            top = sha.Download(self._buf[lo:]).wait()
        for h in stale:
            o = self._offset(h) - lo
            self._mirror[h] = top[o:o + (self._cap >> h)].copy()
            self._mirror_count[h] = self._size >> h
            self.dispatch_stats["mirror_level_downloads"] += 1
            self.dispatch_stats["mirror_rows_downloaded"] += self._cap >> h

    # ------------------------------------------------------------- reads

    def _node_bytes(self, height: int, index: int) -> bytes:
        if index < self._mirror_count.get(height, 0):
            return self._mirror[height][index].tobytes()
        self.dispatch_stats["row_reads"] += 1
        return sha.Download(self._level(height)[index]).wait().tobytes()

    @staticmethod
    def _frontier_of(n: int) -> List[Tuple[int, int]]:
        """Full aligned subtrees of a size-n tree: [(height, node_idx)]
        left to right (descending height)."""
        return [(h, (n >> h) - 1)
                for h in range(n.bit_length() - 1, -1, -1)
                if (n >> h) & 1]

    def _frontier_roots(self, n: int) -> List[bytes]:
        roots = self._froot_cache.get(n)
        if roots is None:
            roots = [self._node_bytes(h, idx)
                     for h, idx in self._frontier_of(n)]
            self._froot_cache[n] = roots
        return roots

    @property
    def root_hash(self) -> bytes:
        if self._size == 0:
            return self.hasher.hash_empty()
        roots = self._frontier_roots(self._size)
        accum = roots[-1]
        for r in reversed(roots[:-1]):
            accum = self.hasher.hash_children(r, accum)
        return accum

    # ------------------------------------------- proofs (any tree size)

    def sibling_rows(self, idx_np: np.ndarray, g: int) -> np.ndarray:
        """[k * g] int64 buffer rows of the siblings of leaves `idx_np` at
        heights 0..g - 1: row offset(h) + ((m >> h) ^ 1), leaf-sibling
        first for each leaf."""
        heights = np.arange(g, dtype=np.int64)
        offsets = np.asarray([self._offset(h) for h in range(g)],
                             dtype=np.int64)
        return (((idx_np[:, None] >> heights) ^ 1) + offsets).reshape(-1)

    def _low_replicas(self, m, g: int, n: int) -> dict:
        """{device: the buffer's first offset(g) rows (levels 0..g - 1)}
        for every device of the mesh: the tree's own buffer on its device,
        a copy elsewhere. The copies are a snapshot: complete nodes are
        immutable, so a copy made when the tree held `snap` leaves serves
        every gather of a size-n prefix with n <= snap; a larger n, more
        levels or a new buffer (growth, a build) copies again. Each copy
        of the levels counts g replica_broadcasts, one a level, as the
        JAX package counts its per-level broadcasts."""
        cached = self._replicas
        if cached is not None and cached[0] is self._buf \
                and cached[1] >= g and cached[2] >= n:
            return cached[3]
        rows = self._offset(g)
        copies = {dev: self._buf
                  if mesh_mod.same_device(dev, self._buf.device)
                  else self._buf[:rows].to(dev)
                  for dev in set(m.devices)}
        self.dispatch_stats["replica_broadcasts"] += g
        self._replicas = (self._buf, g, self._size, copies)
        return copies

    def _gather_low(self, idx_np: np.ndarray, g: int,
                    n: Optional[int] = None) -> sha.Download:
        """The siblings of the bottom g levels for one proof batch against
        the size-n prefix, gathered by one index_select into [k, g * 32]
        bytes (big-endian as stored) and copied to the host without
        blocking. A batch that clears the mesh gate is padded (row 0
        repeated) and split over the mesh's devices, each gathering from
        its copy of the levels; the rows are gathered onto the tree's
        device and cut to k."""
        k = int(idx_np.shape[0])
        n = self._size if n is None else n
        self.dispatch_stats["gather_dispatches"] += 1
        m = mesh_mod.get_mesh()
        with self.tracer.span("merkle_gather_dispatch", CAT_DEVICE, n=k):
            if m.should_shard(k, self.device):
                levels = self._low_replicas(m, g, n)
                kp = m.padded_size(k, min_per_device=1)
                idx_p = mesh_mod.pad_rows([idx_np], kp)[0]
                outs = m.dispatch(
                    lambda src, rows: src.index_select(0, rows).view(
                        -1, g * 32),
                    [idx_p], n=k, label="merkle_gather",
                    place=lambda shard, dev: (
                        levels[dev],
                        to_tensor(self.sibling_rows(shard[0], g), dev)))
                return sha.Download(m.gather(outs, self.device)[:k])
            m.note_passthrough(k)
            packed = self._buf.index_select(
                0, self._upload(self.sibling_rows(idx_np, g))).view(
                    k, g * 32)
            return sha.Download(packed)

    def dispatch_proof_batch(self, indices: Sequence[int],
                             n: Optional[int] = None):
        """Start the device gather for one RFC 6962 inclusion-proof batch
        against the size-`n` prefix tree (default: current size). Pair
        with collect_proof_batch; interleaving dispatch and collect across
        batches overlaps the next gather with the current download
        (ProofPipeline does this)."""
        n = self._size if n is None else n
        if not 0 < n <= self._size:
            raise ValueError("invalid proof-batch size {} for tree of "
                             "size {}".format(n, self._size))
        idx_np = np.asarray(list(indices), dtype=np.int64)
        if idx_np.size and not (0 <= idx_np.min()
                                and int(idx_np.max()) < n):
            raise ValueError("proof index out of range for size "
                             "{}".format(n))
        if n == 1:
            return (idx_np, None, n, 0, [], [])
        self._ensure_mirrors()
        fr = self._frontier_of(n)
        roots = self._frontier_roots(n)
        h0 = fr[0][0]
        g = min(self._n_low(), h0)
        low = None
        if g and idx_np.size:
            low = self._gather_low(idx_np, g, n)
        return (idx_np, low, n, g, fr, roots)

    def collect_proof_batch(self, handle) -> List[List[bytes]]:
        """Await a dispatch_proof_batch handle → per-leaf RFC 6962 audit
        paths (leaf-sibling first), byte-identical to
        CompactMerkleTree.inclusion_proofs_batch."""
        idx_np, low, n, g, fr, roots = handle
        k = idx_np.shape[0]
        if n == 1 or k == 0:
            return [[] for _ in range(k)]
        low_np = low.wait().reshape(k, g, 32) if low is not None else None
        r = len(fr)
        starts = np.asarray([node_idx << h for h, node_idx in fr],
                            dtype=np.int64)
        js = np.searchsorted(starts, idx_np, side="right") - 1
        # MTH of everything right of subtree j, shared across the batch
        sfx: List[Optional[bytes]] = [None] * r
        accum = None
        hash_children = self.hasher.hash_children
        for j in range(r - 1, 0, -1):
            accum = roots[j] if accum is None \
                else hash_children(roots[j], accum)
            sfx[j - 1] = accum
        h0 = fr[0][0]
        # vectorized host joins for the mirrored middle heights
        mirror_cols = {h: self._mirror[h][(idx_np >> h) ^ 1]
                       for h in range(g, h0)}
        out = []
        for i in range(k):
            j = int(js[i])
            hj = fr[j][0]
            path = []
            for h in range(hj):
                if h < g:
                    path.append(low_np[i, h].tobytes())
                else:
                    path.append(mirror_cols[h][i].tobytes())
            if j < r - 1:
                path.append(sfx[j])
            for jj in range(j - 1, -1, -1):
                path.append(roots[jj])
            out.append(path)
        return out

    def inclusion_proofs(self, indices: Sequence[int],
                         n: Optional[int] = None) -> List[List[bytes]]:
        """Audit paths for many leaves of the size-n prefix tree, served
        from the device levels, for ANY n <= tree_size."""
        return self.collect_proof_batch(
            self.dispatch_proof_batch(indices, n))

    # ------------------------------ dense power-of-two path (the bench's)

    def _check_pow2(self):
        if self._size != self._cap:
            raise ValueError("dense audit-path batches need a "
                             "power-of-two tree (got size {}); use "
                             "inclusion_proofs for ragged sizes"
                             .format(self._size))

    def dispatch_path_batch(self, indices: Sequence[int]):
        """Dense power-of-two variant of dispatch_proof_batch: the collect
        returns one uint8 [k, depth, 32] buffer."""
        self._check_pow2()
        idx_np = np.asarray(list(indices), dtype=np.int64)
        if self._depth() == 0:
            return (idx_np, None)
        self._ensure_mirrors()
        g = min(self._n_low(), self._depth())
        low = self._gather_low(idx_np, g) if g else None
        return (idx_np, low)

    def collect_path_batch(self, handle) -> np.ndarray:
        """Await a dispatch_path_batch handle → uint8 [k, depth, 32]
        (leaf-sibling first): the gathered bottom levels as they arrive,
        the top levels from the host mirror by numpy gathers."""
        idx_np, low = handle
        depth = self._depth()
        k = idx_np.shape[0]
        out = np.empty((k, depth, 32), dtype=np.uint8)
        g = min(self._n_low(), depth)
        if low is not None:
            out[:, :g] = low.wait().reshape(k, g, 32)
        for h in range(g, depth):
            out[:, h] = self._mirror[h][(idx_np >> h) ^ 1]
        return out

    def audit_path_batch_array(self, indices) -> np.ndarray:
        """Audit paths for many leaves → uint8 [k, depth, 32]: one device
        gather (bottom levels) and host joins (mirrored top levels).
        Power-of-two sizes only; ragged sizes go through
        inclusion_proofs."""
        return self.collect_path_batch(self.dispatch_path_batch(indices))

    def audit_path_batch(self, indices: Sequence[int]) -> List[List[bytes]]:
        """List-of-lists audit paths for the CURRENT tree size, ragged
        sizes included (RFC 6962 frontier decomposition)."""
        if self._size == self._cap:
            if self._depth() == 0:
                return [[] for _ in indices]
            arr = self.audit_path_batch_array(indices)
            k, depth = arr.shape[0], arr.shape[1]
            flat = arr.reshape(k * depth, 32).tobytes()
            mv = memoryview(flat)
            return [[bytes(mv[(i * depth + h) * 32:
                             (i * depth + h + 1) * 32])
                     for h in range(depth)] for i in range(k)]
        return self.inclusion_proofs(indices, self._size)

    def verify_path(self, leaf: bytes, index: int, path: List[bytes],
                    root: bytes) -> bool:
        """Power-of-two fold check (the dense path's; MerkleVerifier
        checks ragged sizes)."""
        h = self.hasher.hash_leaf(leaf)
        for height, sibling in enumerate(path):
            if (index >> height) & 1:
                h = self.hasher.hash_children(sibling, h)
            else:
                h = self.hasher.hash_children(h, sibling)
        return h == root


class ProofPipeline:
    """Double-buffered proof-batch streamer over a DeviceMerkleTree: up to
    `depth` gathers stay in flight, so the card gathers batch i + 1 while
    the host joins batch i. `chunk` is run()'s batch size (the node's
    MERKLE_DEVICE_PROOF_CHUNK; None takes the Config default)."""

    def __init__(self, tree: DeviceMerkleTree, depth: int = 2,
                 dense: bool = False, tracer=None, chunk: int = None):
        self._tree = tree
        self._depth = max(1, depth)
        self._dense = dense
        self._tracer = tracer or NullTracer()
        self.chunk = max(1, chunk if chunk is not None
                         else Config.MERKLE_DEVICE_PROOF_CHUNK)

    def stream(self, batches, n: Optional[int] = None):
        """Yield one result per index batch, in order: uint8 [k, depth, 32]
        buffers in dense mode, per-leaf bytes-list paths otherwise."""
        if self._dense:
            dispatch = self._tree.dispatch_path_batch
            collect = self._tree.collect_path_batch
        else:
            dispatch = functools.partial(
                self._tree.dispatch_proof_batch, n=n)
            collect = self._tree.collect_proof_batch
        tracer = self._tracer
        pending = deque()
        for batch in batches:
            # the dispatch span is the host's launch cost; the in-flight
            # counter shows whether the overlap keeps the card busy
            with tracer.span("proof_dispatch", CAT_DEVICE, n=len(batch)):
                pending.append(dispatch(batch))
            tracer.counter("proof_inflight", len(pending))
            if len(pending) >= self._depth:
                with tracer.span("proof_collect", CAT_DEVICE):
                    out = collect(pending.popleft())
                yield out
        while pending:
            with tracer.span("proof_collect", CAT_DEVICE):
                out = collect(pending.popleft())
            yield out

    def run(self, indices: Sequence[int], n: Optional[int] = None,
            chunk: int = None) -> List[List[bytes]]:
        """Split one large proof request into pipelined batches of `chunk`
        (this pipeline's by default) and return the per-leaf paths."""
        chunk = self.chunk if chunk is None else max(1, chunk)
        idx = list(indices)
        if not idx:
            return []
        batches = [idx[i:i + chunk] for i in range(0, len(idx), chunk)]
        out: List[List[bytes]] = []
        for part in self.stream(batches, n=n):
            out.extend(part)
        return out
