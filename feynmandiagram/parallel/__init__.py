"""Scale-out: device meshes and sample-axis data parallelism.

The Monte-Carlo sample axis is embarrassingly parallel — each chip
evaluates its own sample shard through the identical lowered graph, and
observable estimates reduce with one ``pmean``.  Level-partitioned
evaluation of DAGs too large for one device (BASELINE config 5,
``graph_shard``) builds on the same mesh.
"""
from .sharding import (make_sample_mesh, shard_compiled, make_mc_step,
                       BATCH_AXIS)
from .graph_shard import (make_graph_sharded_evaluator,
                          make_graph_sharded_mc_step, GRAPH_AXIS)
