"""The cohort's split over processes (counterpart of
``remixt_tpu/parallel/distributed.py``'s ``cohort_partition``).

Every process computes the same assignment without communication: the
sample ids sorted by ``str`` and dealt round-robin. The process's rank and
the number of processes come from ``torch.distributed`` when a process
group is initialized, else this is the only process.
"""


def cohort_partition(sample_ids, process_id=None, process_count=None):
    """This process's share of the samples ``sample_ids``, in the order
    it fits them."""
    if process_id is None or process_count is None:
        import torch.distributed as dist
        initialized = dist.is_available() and dist.is_initialized()
        if process_id is None:
            process_id = dist.get_rank() if initialized else 0
        if process_count is None:
            process_count = dist.get_world_size() if initialized else 1
    ordered = sorted(sample_ids, key=str)
    return ordered[process_id::process_count]
