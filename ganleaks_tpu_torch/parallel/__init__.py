"""Multi-GPU layouts of the attack over ``torch.distributed`` (port of
``ganleaks_tpu.parallel``): the mesh value and its collectives
(``mesh``), the process wire-up and local launcher (``multihost``), and
the sharded and ring kNN searches (``knn_shard``)."""
