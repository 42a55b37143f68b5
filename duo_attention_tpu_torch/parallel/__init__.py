"""Parallel layouts on ``torch.distributed`` (counterpart of duo_attention_tpu/parallel/).

``mesh.py``: the mesh of process groups ((data, tensor) for inference,
(data, seq) for gate training), its collectives, the tensor-parallel
sharding rules, the rank spawner and the dry runs (the 1M-token sharded
decode among them). ``spmd.py``: the head-sharded attention calls.
``pipeline.py``: the layer-stage engine. ``ulysses.py``: the sequence <->
head all_to_all of sequence-parallel training. ``fsdp.py``: the frozen
params split over every rank and gathered a layer at a time.
"""
