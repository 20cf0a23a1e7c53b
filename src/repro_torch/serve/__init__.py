"""repro_torch.serve — the influence serving tier.

A Nyström sketch costs k HVPs to build and then answers IHVP queries as
plain contractions, so a serving layer builds it once and reuses it across
every query that shares a linearization point. Three layers:

  SketchStore       content-addressed LRU cache of prepared solver states,
                    keyed by (params digest, solver fingerprint), with a
                    disk tier; a warm hit answers queries with zero build
                    HVPs
  QueryBatcher      micro-batching of single query vectors into the (p, m)
                    blocks ``apply_matrix`` takes, flushing on deadline or
                    block size
  InfluenceService  an in-process request/response loop over both, with
                    bounded-queue backpressure, per-request deadlines, CG
                    degradation on a failed sketch build, and schema-v2
                    bench metrics
"""
from repro_torch.serve.batcher import (PendingQuery, QueryBatcher,
                                       calibrate_block_size)
from repro_torch.serve.service import (InfluenceRequest, InfluenceResponse,
                                       InfluenceService, ServiceOverloaded)
from repro_torch.serve.store import (CacheEntry, SketchKey, SketchStore,
                                     sketch_key)

__all__ = [
    'CacheEntry', 'InfluenceRequest', 'InfluenceResponse', 'InfluenceService',
    'PendingQuery', 'QueryBatcher', 'ServiceOverloaded', 'SketchKey',
    'SketchStore', 'calibrate_block_size', 'sketch_key',
]
