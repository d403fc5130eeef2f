"""Work split over processes and devices: the share of a sample cohort
that this process fits (``distributed.cohort_partition``)."""
