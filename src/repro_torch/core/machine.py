"""Machine models: heterogeneous cores + hierarchical communication.

The paper's key observation (§1, Fig. 1): on a multicore, "the
communication time between two cores is given by the time required to
access the corresponding memory" — i.e. the *lowest shared memory level*
between the two cores. A cluster of multicores adds network levels
(Fig. 2). We encode this as a per-core ``location`` tuple; the first
index from the left where two locations differ selects the communication
level.

Levels are (latency_s, bandwidth_bytes_per_s). ``comm_time`` converts an
MPAHA edge volume into time, which is the only machine-specific quantity
AMTHA needs.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CommLevel:
    name: str
    latency: float          # seconds
    bandwidth: float        # bytes / second


@dataclass
class MachineModel:
    """``core_types[c]`` = processor-type id of core c.
    ``locations[c]`` = hierarchical address, e.g. (blade, socket, pair, core).
    ``levels[d]`` = comm level used when two locations first differ at
    depth d (d=0 -> outermost, slowest). Same core -> zero cost.

    Heterogeneity lives in the per-type subtask times of the MPAHA graph;
    ``type_speeds`` / ``type_mem_bw`` (per-type peak FLOP/s and local
    memory bytes/s) exist so cost *extractors* can
    derive those per-type times from application FLOP/byte profiles.
    Empty tuples mean "not modelled" — the algorithm layer never reads
    them."""

    name: str
    core_types: list[int]
    locations: list[tuple[int, ...]]
    levels: list[CommLevel]
    n_types: int = 1
    type_speeds: tuple[float, ...] = ()
    type_mem_bw: tuple[float, ...] = ()

    def __post_init__(self) -> None:
        assert len(self.core_types) == len(self.locations)
        depth = len(self.locations[0])
        assert all(len(loc) == depth for loc in self.locations)
        assert len(self.levels) == depth, "one level per location depth"
        self.n_types = max(self.core_types) + 1

    @property
    def n_cores(self) -> int:
        return len(self.core_types)

    def type_counts(self) -> list[int]:
        counts = [0] * self.n_types
        for t in self.core_types:
            counts[t] += 1
        return counts

    def comm_level(self, a: int, b: int) -> CommLevel | None:
        """The level through which cores a and b communicate (None = same core)."""
        if a == b:
            return None
        la, lb = self.locations[a], self.locations[b]
        for d, (xa, xb) in enumerate(zip(la, lb)):
            if xa != xb:
                return self.levels[d]
        return self.levels[-1]      # same leaf position but different core id

    def comm_time(self, volume: float, a: int, b: int) -> float:
        lvl = self.comm_level(a, b)
        if lvl is None:
            return 0.0
        return lvl.latency + volume / lvl.bandwidth

    def level_index(self, a: int, b: int) -> int:
        """Depth index of the shared level (for the contention simulator)."""
        if a == b:
            return -1
        la, lb = self.locations[a], self.locations[b]
        for d, (xa, xb) in enumerate(zip(la, lb)):
            if xa != xb:
                return d
        return len(self.levels) - 1


# --------------------------------------------------------------------------
# Factories — the paper's two testbeds and their cluster generalisations.
# --------------------------------------------------------------------------

def dell_poweredge_1950() -> MachineModel:
    """§5.2 initial architecture: 2× quad-core Xeon E5410, 4 GB shared RAM,
    6 MB L2 shared per *pair* of cores. Hierarchy: RAM (socket-to-socket
    and intra-socket across pairs) > L2 (pair). Location = (socket, pair, core).
    Bandwidths are order-of-magnitude 2008-era figures; AMTHA only needs
    the ratios to be sane."""
    locations, types = [], []
    for socket in range(2):
        for pair in range(2):
            for core in range(2):
                locations.append((socket, pair, core))
                types.append(0)
    levels = [
        CommLevel("ram-socket", 4e-7, 3.0e9),   # cross-socket via FSB/RAM
        CommLevel("ram-local", 3e-7, 5.0e9),    # same socket, different pair
        CommLevel("l2-pair", 5e-8, 2.0e10),     # shared 6MB L2
    ]
    return MachineModel("dell-poweredge-1950 (8 cores)", types, locations, levels)


def hp_bl260c(n_blades: int = 8) -> MachineModel:
    """§5.2 current architecture: 8 blades × 2 sockets × quad-core E5405
    = 64 cores, gigabit interconnect between blades. Location =
    (blade, socket, pair, core)."""
    locations, types = [], []
    for blade in range(n_blades):
        for socket in range(2):
            for pair in range(2):
                for core in range(2):
                    locations.append((blade, socket, pair, core))
                    types.append(0)
    levels = [
        CommLevel("gigabit-eth", 5e-5, 1.1e8),  # ~1 Gb/s + MPI latency
        CommLevel("ram-socket", 4e-7, 3.0e9),
        CommLevel("ram-local", 3e-7, 5.0e9),
        CommLevel("l2-pair", 5e-8, 2.0e10),
    ]
    return MachineModel(f"hp-bl260c ({n_blades * 8} cores)", types, locations, levels)


def heterogeneous_cluster(n_fast: int = 4, n_slow: int = 4) -> MachineModel:
    """A two-type machine to exercise the 'H' in AMTHA (the paper's
    testbeds are homogeneous but the algorithm is not)."""
    locations = [(0, i) for i in range(n_fast)] + [(1, i) for i in range(n_slow)]
    types = [0] * n_fast + [1] * n_slow
    levels = [CommLevel("eth", 5e-5, 1.1e8), CommLevel("ram", 3e-7, 5.0e9)]
    return MachineModel("hetero 2-type cluster", types, locations, levels)


def cluster_of_multicores(n_blades: int = 4, sockets_per_blade: int = 2,
                          pairs_per_socket: int = 2, n_types: int = 1) -> MachineModel:
    """The paper's closing target (§7): "clusters of multicores". Each
    blade is a PowerEdge-style multicore (sockets × shared-L2 core
    pairs); blades are joined by a 10 GbE fabric, one hierarchy level
    above the intra-blade memory levels. With ``n_types > 1`` alternate
    blades get faster/slower cores so the online scheduler also exercises
    heterogeneity. Location = (blade, socket, pair, core)."""
    locations, types = [], []
    for blade in range(n_blades):
        for socket in range(sockets_per_blade):
            for pair in range(pairs_per_socket):
                for core in range(2):
                    locations.append((blade, socket, pair, core))
                    types.append(blade % n_types)
    levels = [
        CommLevel("10gbe", 2e-5, 1.1e9),        # inter-blade fabric
        CommLevel("ram-socket", 4e-7, 3.0e9),
        CommLevel("ram-local", 3e-7, 5.0e9),
        CommLevel("l2-pair", 5e-8, 2.0e10),
    ]
    n_cores = n_blades * sockets_per_blade * pairs_per_socket * 2
    return MachineModel(f"cluster-of-multicores ({n_blades}x{n_cores // n_blades} cores)",
                        types, locations, levels)
