"""CLAY (coupled-layer) MSR regenerating code plugin.

Re-implements, from the published construction (Vajha et al., "Clay
Codes: Moulding MDS Codes to Yield an MSR Code", FAST 2018), the
behavior of the reference's only array-code plugin (reference
src/erasure-code/clay/ErasureCodeClay.{h,cc} +
ErasureCodePluginClay.cc) — the one plugin whose
``get_sub_chunk_count() > 1`` (reference clay/ErasureCodeClay.h:57-58,
``sub_chunk_no = q^t``).

Construction summary.  Parameters (k, m, d) with d in [k, k+m-1]:

* q = d - k + 1; the k+m chunks (padded with ``nu`` virtual zero chunks
  so q divides the total) sit on a q x t grid of *nodes*,
  t = (k+m+nu)/q; node (x, y) has index y*q + x.
* Each chunk is an array of sub_chunk_no = q^t *sub-chunks*, one per
  "plane" z, a base-q number (z_0 .. z_{t-1}) with digit z_y selecting
  the *dot* node (z_y, y) of the plane.
* Uncoupled data U(node, z) relates to on-disk (coupled) data
  C(node, z) through a pairwise transform (PFT) linking
  (x, y, z) <-> (x', y, z') where x' = z_y, z' = z with digit y
  replaced by x: dot nodes (x == z_y) have U = C; other pairs are
  jointly invertible from any two of {C, C', U, U'}.  The PFT is
  realized as a (2, 2) MDS code over the pair, instantiated from the
  registry (the ``pft`` inner code; reference ErasureCodeClay.cc:79-85).
* Within each plane the uncoupled values satisfy a (k+nu, m) scalar MDS
  code (the ``mds`` inner code, ditto:72-78).

Encode = declare the m parity nodes erased and run layered decoding.
Repair of a single node reads only the q^(t-1) planes whose y-digit
equals the lost node's x (the lost node's *dot planes*) from d helpers
— the sub_chunk_no/q repair-bandwidth saving that makes CLAY MSR
(reference repair path ErasureCodeClay.cc:395-646).

Interop: ``scalar_mds`` profile key picks the inner plugin
(jerasure | isa | shec | gpu here — gpu is this framework's extension,
running the inner MDS and PFT codes on the card through kernel B1),
``technique`` passes through.  A ``device`` key in the CLAY profile is
passed on to both inner profiles when ``scalar_mds=gpu``; without it
they mean CUDA, as the ``gpu`` plugin does.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Set, Tuple

import numpy as np

from ..interface import (ErasureCode, ErasureCodeProfile,
                         ErasureCodeValidationError)
from ..registry import ErasureCodePlugin


def pow_int(a: int, x: int) -> int:
    return a ** x


class ErasureCodeClay(ErasureCode):
    """Coupled-layer code (reference clay/ErasureCodeClay.h:24)."""

    DEFAULT_K = "4"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def __init__(self) -> None:
        super().__init__()
        self.k = 0
        self.m = 0
        self.d = 0
        self.w = 8
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None   # (k+nu, m) scalar MDS inner codec
        self.pft = None   # (2, 2) pairwise-transform inner codec

    # -- plumbing ---------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        from ..registry import ErasureCodePluginRegistry
        mds_profile, pft_profile = self.parse(profile)
        super().init(profile)
        registry = ErasureCodePluginRegistry.instance()
        self.mds = registry.factory(mds_profile["plugin"], dict(mds_profile))
        self.pft = registry.factory(pft_profile["plugin"], dict(pft_profile))

    def parse(self, profile: ErasureCodeProfile
              ) -> Tuple[Dict[str, str], Dict[str, str]]:
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, str(self.k + self.m - 1))

        scalar_mds = self.to_string("scalar_mds", profile, "jerasure")
        if scalar_mds not in ("jerasure", "isa", "shec", "gpu"):
            raise ErasureCodeValidationError(
                f"scalar_mds {scalar_mds!r} is not supported, use one of "
                "'jerasure', 'isa', 'shec', 'gpu'")
        technique = self.to_string("technique", profile, "reed_sol_van")
        allowed = {
            "jerasure": ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                         "cauchy_good", "liber8tion"),
            "isa": ("reed_sol_van", "cauchy"),
            "shec": ("single", "multiple"),
            "gpu": ("reed_sol_van", "cauchy_good"),
        }[scalar_mds]
        if technique not in allowed:
            raise ErasureCodeValidationError(
                f"technique {technique!r} not supported for "
                f"scalar_mds={scalar_mds}, use one of {allowed}")

        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ErasureCodeValidationError(
                f"value of d {self.d} must be within "
                f"[{self.k},{self.k + self.m - 1}]")

        self.q = self.d - self.k + 1
        self.nu = (-(self.k + self.m)) % self.q
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeValidationError("k+m+nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = pow_int(self.q, self.t)

        mds_profile = {"plugin": scalar_mds, "technique": technique,
                       "k": str(self.k + self.nu), "m": str(self.m),
                       "w": "8"}
        pft_profile = {"plugin": scalar_mds, "technique": technique,
                       "k": "2", "m": "2", "w": "8"}
        if scalar_mds == "shec":
            mds_profile["c"] = pft_profile["c"] = "2"
        if scalar_mds == "gpu" and "device" in profile:
            mds_profile["device"] = pft_profile["device"] = \
                profile["device"]
        return mds_profile, pft_profile

    # -- geometry ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        # reference ErasureCodeClay.cc:90-96
        alignment = self.sub_chunk_no * self.k * self.pft.get_chunk_size(1)
        return -(-object_size // alignment) * alignment // self.k

    def _node_of_chunk(self, i: int) -> int:
        """Chunk id -> grid node id (parities shifted past the nu virtual
        zero nodes)."""
        return i if i < self.k else i + self.nu

    def _chunk_of_node(self, n: int) -> int:
        return n if n < self.k else n - self.nu

    def get_plane_vector(self, z: int) -> List[int]:
        z_vec = [0] * self.t
        for i in range(self.t):
            z_vec[self.t - 1 - i] = z % self.q
            z //= self.q
        return z_vec

    def _z_sw(self, x: int, y: int, z: int, z_vec: List[int]) -> int:
        """Plane of the coupling partner: digit y of z replaced by x."""
        return z + (x - z_vec[y]) * pow_int(self.q, self.t - 1 - y)

    # -- repair locality (reference ErasureCodeClay.cc:306-392) -----------
    def is_repair(self, want_to_read: Set[int],
                  available: Set[int]) -> bool:
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        lost = self._node_of_chunk(next(iter(want_to_read)))
        # every same-column (same y-group) node other than the lost one
        # must be available
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            chunk = self._chunk_of_node(node)
            if self.k <= node < self.k + self.nu:
                continue
            if chunk != next(iter(want_to_read)) and chunk not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> List[Tuple[int, int]]:
        """(offset, count) runs of the planes with z_{y_lost} == x_lost."""
        y_lost, x_lost = divmod(lost_node, self.q)
        seq_sc_count = pow_int(self.q, self.t - 1 - y_lost)
        num_seq = pow_int(self.q, y_lost)
        out = []
        index = x_lost * seq_sc_count
        for _ in range(num_seq):
            out.append((index, seq_sc_count))
            index += self.q * seq_sc_count
        return out

    def get_repair_sub_chunk_count(self, want_to_read: Set[int]) -> int:
        weight = [0] * self.t
        for c in want_to_read:
            weight[self._node_of_chunk(c) // self.q] += 1
        untouched = 1
        for y in range(self.t):
            untouched *= self.q - weight[y]
        return self.sub_chunk_no - untouched

    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]
                          ) -> Dict[int, List[Tuple[int, int]]]:
        if self.is_repair(want_to_read, available):
            return self.minimum_to_repair(want_to_read, available)
        return super().minimum_to_decode(want_to_read, available)

    def minimum_to_repair(self, want_to_read: Set[int],
                          available: Set[int]
                          ) -> Dict[int, List[Tuple[int, int]]]:
        lost = self._node_of_chunk(next(iter(want_to_read)))
        sub_ind = self.get_repair_subchunks(lost)
        minimum: Dict[int, List[Tuple[int, int]]] = {}
        # same-column helpers first (they carry the coupling partners)
        for j in range(self.q):
            if j == lost % self.q:
                continue
            node = (lost // self.q) * self.q + j
            if node < self.k or node >= self.k + self.nu:
                minimum[self._chunk_of_node(node)] = list(sub_ind)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            if chunk not in minimum:
                minimum[chunk] = list(sub_ind)
        assert len(minimum) == self.d
        return minimum

    # -- entry points ------------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        chunk_size = len(encoded[0])
        nodes = {}
        parity_nodes = set()
        for i in range(self.k + self.m):
            n = self._node_of_chunk(i)
            nodes[n] = encoded[i]
            if i >= self.k:
                parity_nodes.add(n)
        for n in range(self.k, self.k + self.nu):
            nodes[n] = np.zeros(chunk_size, dtype=np.uint8)
        self.decode_layered(parity_nodes, nodes)

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: Dict[int, np.ndarray]) -> None:
        erasures = set()
        nodes = {}
        for i in range(self.k + self.m):
            n = self._node_of_chunk(i)
            if i not in chunks:
                erasures.add(n)
            nodes[n] = decoded[i]
        chunk_size = len(decoded[0])
        for n in range(self.k, self.k + self.nu):
            nodes[n] = np.zeros(chunk_size, dtype=np.uint8)
        self.decode_layered(erasures, nodes)

    def decode(self, want_to_read: Set[int], chunks: Mapping[int, bytes],
               chunk_size: int = 0) -> Dict[int, bytes]:
        avail = set(chunks)
        first_len = len(next(iter(chunks.values()))) if chunks else 0
        if (self.is_repair(set(want_to_read), avail)
                and chunk_size > first_len):
            return self.repair(set(want_to_read), chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size)

    # -- full-plane layered decode (reference ErasureCodeClay.cc:648-723) -
    def decode_layered(self, erased_nodes: Set[int],
                       nodes: Dict[int, np.ndarray]) -> None:
        """Recover every erased node's chunk, in place, from the others.

        ``nodes`` maps every grid node (incl. the nu virtual zero nodes)
        to its full coupled chunk buffer.
        """
        assert erased_nodes
        size = len(nodes[0])
        assert size % self.sub_chunk_no == 0
        sc_size = size // self.sub_chunk_no

        erasures = set(erased_nodes)
        # pad the erasure set to exactly m nodes (extra parity nodes get
        # recomputed) so each plane's MDS decode sees a full signature
        for i in range(self.k + self.nu, self.q * self.t):
            if len(erasures) >= self.m:
                break
            erasures.add(i)
        assert len(erasures) == self.m

        U = {n: np.zeros(size, dtype=np.uint8)
             for n in range(self.q * self.t)}

        # plane order = intersection score: number of erased nodes that
        # are "dots" of the plane
        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        for z in range(self.sub_chunk_no):
            z_vec = self.get_plane_vector(z)
            order[z] = sum(1 for n in erasures
                           if n % self.q == z_vec[n // self.q])
        max_score = int(order.max(initial=0))

        for iscore in range(max_score + 1):
            planes = np.nonzero(order == iscore)[0]
            for z in planes:
                self._decode_erasures(erasures, int(z), nodes, U, sc_size)
            for z in planes:
                z = int(z)
                z_vec = self.get_plane_vector(z)
                for node_xy in sorted(erasures):
                    x, y = node_xy % self.q, node_xy // self.q
                    node_sw = y * self.q + z_vec[y]
                    if z_vec[y] != x:
                        if node_sw not in erasures:
                            self._recover_type1(nodes, U, x, y, z, z_vec,
                                                sc_size)
                        elif z_vec[y] < x:
                            self._coupled_from_uncoupled(nodes, U, x, y, z,
                                                         z_vec, sc_size)
                    else:  # dot node: C == U
                        nodes[node_xy][z * sc_size:(z + 1) * sc_size] = \
                            U[node_xy][z * sc_size:(z + 1) * sc_size]

    def _decode_erasures(self, erasures: Set[int], z: int,
                         nodes: Dict[int, np.ndarray],
                         U: Dict[int, np.ndarray], sc_size: int) -> None:
        """Fill U(*, z) for surviving nodes, then MDS-decode the plane
        (reference ErasureCodeClay.cc:725-760)."""
        z_vec = self.get_plane_vector(z)
        for x in range(self.q):
            for y in range(self.t):
                node_xy = self.q * y + x
                node_sw = self.q * y + z_vec[y]
                if node_xy in erasures:
                    continue
                if z_vec[y] < x:
                    self._uncoupled_from_coupled(nodes, U, x, y, z, z_vec,
                                                 sc_size)
                elif z_vec[y] == x:
                    U[node_xy][z * sc_size:(z + 1) * sc_size] = \
                        nodes[node_xy][z * sc_size:(z + 1) * sc_size]
                elif node_sw in erasures:
                    self._uncoupled_from_coupled(nodes, U, x, y, z, z_vec,
                                                 sc_size)
        self._decode_uncoupled(erasures, z, U, sc_size)

    def _decode_uncoupled(self, erasures: Set[int], z: int,
                          U: Dict[int, np.ndarray], sc_size: int) -> None:
        """MDS-decode plane z of the uncoupled arrays in place
        (reference ErasureCodeClay.cc:762-780)."""
        sl = slice(z * sc_size, (z + 1) * sc_size)
        known = {n: U[n][sl] for n in range(self.q * self.t)
                 if n not in erasures}
        decoded = {n: U[n][sl] for n in range(self.q * self.t)}
        self.mds.decode_chunks(set(erasures), known, decoded)

    # -- pairwise transform helpers (reference ErasureCodeClay.cc:797-874)
    #
    # PFT chunk ids: {0, 1} = coupled pair (lower x first), {2, 3} =
    # uncoupled pair.  Any two of the four recover the rest through the
    # (2,2) MDS pft code.
    def _pft_pair(self, nodes, U, x, y, z, z_vec, sc_size):
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = self._z_sw(x, y, z, z_vec)
        swap = z_vec[y] > x
        c_xy = nodes[node_xy][z * sc_size:(z + 1) * sc_size]
        c_sw = nodes[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size]
        u_xy = U[node_xy][z * sc_size:(z + 1) * sc_size]
        u_sw = U[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size]
        if swap:
            return {0: c_sw, 1: c_xy, 2: u_sw, 3: u_xy}
        return {0: c_xy, 1: c_sw, 2: u_xy, 3: u_sw}

    def _pft_solve(self, pair: Dict[int, np.ndarray],
                   erased: Set[int]) -> None:
        """Solve the (2,2) pairwise transform: entries in ``erased`` are
        written in place from the two known entries."""
        known = {i: pair[i] for i in pair if i not in erased}
        self.pft.decode_chunks(erased, known, pair)

    def _uncoupled_from_coupled(self, nodes, U, x, y, z, z_vec, sc_size):
        self._pft_solve(self._pft_pair(nodes, U, x, y, z, z_vec, sc_size),
                        {2, 3})

    def _coupled_from_uncoupled(self, nodes, U, x, y, z, z_vec, sc_size):
        self._pft_solve(self._pft_pair(nodes, U, x, y, z, z_vec, sc_size),
                        {0, 1})

    def _recover_type1(self, nodes, U, x, y, z, z_vec, sc_size):
        """C(x,y,z) from the partner's C and own U.  The partner's U slot
        is a scratch buffer — its plane may not be solved yet — so it is
        marked erased alongside our C (reference ErasureCodeClay.cc:797)."""
        pair = self._pft_pair(nodes, U, x, y, z, z_vec, sc_size)
        swap = z_vec[y] > x
        scratch = np.zeros(sc_size, dtype=np.uint8)
        if swap:  # own C at key 1, own U at key 3; partner C 0, U 2
            pair[2] = scratch
            self._pft_solve(pair, {1, 2})
        else:     # own C at key 0, own U at key 2; partner C 1, U 3
            pair[3] = scratch
            self._pft_solve(pair, {0, 3})

    # -- single-node repair (reference ErasureCodeClay.cc:395-646) --------
    def repair(self, want_to_read: Set[int],
               chunks: Mapping[int, bytes], chunk_size: int
               ) -> Dict[int, bytes]:
        """Repair one lost chunk from d helpers carrying only their repair
        sub-chunks (concatenated)."""
        assert len(want_to_read) == 1 and len(chunks) == self.d
        lost_chunk = next(iter(want_to_read))
        lost_node = self._node_of_chunk(lost_chunk)

        repair_sub_count = self.get_repair_sub_chunk_count(want_to_read)
        repair_blocksize = len(next(iter(chunks.values())))
        assert repair_blocksize % repair_sub_count == 0
        sc_size = repair_blocksize // repair_sub_count
        assert self.sub_chunk_no * sc_size == chunk_size

        runs = self.get_repair_subchunks(lost_node)
        # plane id -> index within the helper's repair buffer
        plane_to_ind: Dict[int, int] = {}
        for index, count in runs:
            for j in range(index, index + count):
                plane_to_ind[j] = len(plane_to_ind)

        helper: Dict[int, np.ndarray] = {}
        aloof: Set[int] = set()
        for i in range(self.k + self.m):
            n = self._node_of_chunk(i)
            if i in chunks:
                helper[n] = np.frombuffer(chunks[i], dtype=np.uint8)
            elif i != lost_chunk:
                aloof.add(n)
        for n in range(self.k, self.k + self.nu):
            helper[n] = np.zeros(repair_blocksize, dtype=np.uint8)

        recovered = np.zeros(chunk_size, dtype=np.uint8)
        U = {n: np.zeros(chunk_size, dtype=np.uint8)
             for n in range(self.q * self.t)}

        # the lost node's whole column is unknown in helper planes; aloof
        # nodes are unknown everywhere
        erasures = {lost_node - lost_node % self.q + i
                    for i in range(self.q)} | aloof

        # order repair planes by intersection score w.r.t. lost + aloof
        ordered: Dict[int, List[int]] = {}
        for zp in sorted(plane_to_ind):
            z_vec = self.get_plane_vector(zp)
            score = sum(1 for n in ([lost_node] + sorted(aloof))
                        if n % self.q == z_vec[n // self.q])
            assert score > 0
            ordered.setdefault(score, []).append(zp)

        zeros = np.zeros(sc_size, dtype=np.uint8)
        for score in sorted(ordered):
            for z in ordered[score]:
                z_vec = self.get_plane_vector(z)
                # step 1: uncoupled values of all surviving nodes in z
                for y in range(self.t):
                    for x in range(self.q):
                        node_xy = y * self.q + x
                        if node_xy in erasures:
                            continue
                        node_sw = y * self.q + z_vec[y]
                        z_sw = self._z_sw(x, y, z, z_vec)
                        u_xy = U[node_xy][z * sc_size:(z + 1) * sc_size]
                        c_xy = helper[node_xy][
                            plane_to_ind[z] * sc_size:
                            (plane_to_ind[z] + 1) * sc_size]
                        if z_vec[y] == x:
                            u_xy[:] = c_xy
                        elif node_sw in aloof:
                            # partner C unavailable: solve PFT from own C
                            # and partner U (already computed: aloof dots
                            # resolve in earlier planes of lower score)
                            u_sw = U[node_sw][z_sw * sc_size:
                                              (z_sw + 1) * sc_size]
                            swap = z_vec[y] > x
                            if swap:
                                pair = {0: zeros.copy(), 1: c_xy.copy(),
                                        2: u_sw.copy(), 3: u_xy}
                                self._pft_solve(pair, {0, 3})
                            else:
                                pair = {0: c_xy.copy(), 1: zeros.copy(),
                                        2: u_xy, 3: u_sw.copy()}
                                self._pft_solve(pair, {1, 2})
                        else:
                            # partner's C is in the helper data (same
                            # column as lost node => z_sw is a repair
                            # plane)
                            c_sw = helper[node_sw][
                                plane_to_ind[z_sw] * sc_size:
                                (plane_to_ind[z_sw] + 1) * sc_size]
                            u_sw_scratch = zeros.copy()
                            swap = z_vec[y] > x
                            if swap:
                                pair = {0: c_sw.copy(), 1: c_xy.copy(),
                                        2: u_sw_scratch, 3: u_xy}
                            else:
                                pair = {0: c_xy.copy(), 1: c_sw.copy(),
                                        2: u_xy, 3: u_sw_scratch}
                            self._pft_solve(pair, {2, 3})
                # step 2: MDS-decode the plane's uncoupled values
                self._decode_uncoupled(erasures, z, U, sc_size)
                # step 3: coupled values of erased nodes in this plane
                for node in sorted(erasures):
                    if node in aloof:
                        continue
                    x, y = node % self.q, node // self.q
                    node_sw = y * self.q + z_vec[y]
                    z_sw = self._z_sw(x, y, z, z_vec)
                    u_xy = U[node][z * sc_size:(z + 1) * sc_size]
                    if x == z_vec[y]:
                        # hole-dot pair: C == U
                        recovered[z * sc_size:(z + 1) * sc_size] = u_xy
                    else:
                        # same column as lost node; partner plane z_sw is
                        # also a repair plane, partner C known from helper
                        assert y == lost_node // self.q
                        assert node_sw == lost_node
                        c_xy = helper[node][
                            plane_to_ind[z] * sc_size:
                            (plane_to_ind[z] + 1) * sc_size]
                        c_sw = recovered[z_sw * sc_size:
                                         (z_sw + 1) * sc_size]
                        swap = z_vec[y] > x
                        if swap:
                            # known: helper C at 1, helper U at 3
                            pair = {0: c_sw, 1: c_xy.copy(),
                                    2: zeros.copy(), 3: u_xy.copy()}
                            self._pft_solve(pair, {0, 2})
                        else:
                            # known: helper C at 0, helper U at 2
                            pair = {0: c_xy.copy(), 1: c_sw,
                                    2: u_xy.copy(), 3: zeros.copy()}
                            self._pft_solve(pair, {1, 3})
        return {lost_chunk: recovered.tobytes()}


class ErasureCodePluginClay(ErasureCodePlugin):
    """Factory (reference ErasureCodePluginClay.cc:21-38)."""

    def factory(self, profile: ErasureCodeProfile):
        interface = ErasureCodeClay()
        interface.init(profile)
        return interface


def __erasure_code_init__(registry) -> None:
    registry.add("clay", ErasureCodePluginClay())
