"""Work split over processes and devices: the process group and device
meshes (``distributed``), restart sharding over a mesh (``restarts``),
chain and block sharding of the chain scan (``chain``), and the share of a
sample cohort that this process fits (``distributed.cohort_partition``)."""
