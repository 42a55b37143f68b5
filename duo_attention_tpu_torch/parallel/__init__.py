"""Parallel layouts on ``torch.distributed`` (counterpart of duo_attention_tpu/parallel/).

``mesh.py``: the (data, tensor) mesh of process groups, its collectives, the
tensor-parallel sharding rules, the rank spawner and the TP dry runs.
``spmd.py``: the head-sharded attention calls. Pipeline parallelism and the
training layouts (FSDP, Ulysses) are not ported yet (ROADMAP.md §1 item 8).
"""
