"""TeShu core on PyTorch: templated, adaptive, sampled shuffles whose cached
plans replay on the card (:mod:`.torchplan`)."""
from .adaptive import (EffCost, compute_eff_cost, eff_cost_from_ratio,
                       reduction_drift)
from .coscheduler import (POLICIES, CoflowRequest, CoflowScheduler,
                          ScheduleEntry)
from .manager import JOURNAL_VERSION, ShuffleManager, ShuffleRecord
from .messages import (COMBINERS, HASH_PART, MAX, MIN, SUM, Combiner, Msgs, PartFn,
                       partition, range_part, splitmix64)
from .obs import (FlightRecorder, MetricsRegistry, NULL_TRACER, NullTracer,
                  Observability, ShuffleReport, build_report)
from .plancache import (CompiledPlan, LevelDecision, PlanCache, compile_plan,
                        key_diff, plan_key, skew_bucket, stats_signature)
from .primitives import (CostLedger, EndOfStream, FaultInjection, LocalCluster,
                         ShuffleAborted, ShuffleArgs, WorkerContext)
from .resilience import (CheckpointStore, FailureDetector, FailureReport,
                         RecoveryContext, RecoveryCoordinator, SpeculationPolicy,
                         SpeculativeTask, StreamCheckpoint,
                         consistent_resume_stages, repair_plan,
                         try_repair)
from .sampling import (estimate_reduction_ratio,
                       estimate_reduction_ratio_with_fallback, group_of,
                       num_groups_for_rate, partition_aware_sample,
                       random_sample, reduction_ratio, sample_with_fallback)
from .service import (TeShuCluster, TenantClient, TeShuService,
                      dst_load_imbalance)
from .tenancy import (DEFAULT_TENANT, AdmissionQueue, ShuffleSubmission,
                      TenantRegistry, TenantSpec)
from .skew import (DEFAULT_SKEW_THRESHOLD, HeavyHitterSketch, LocalSkewStats,
                   MAX_SKETCH_CAPACITY, MIN_SKETCH_CAPACITY, SkewDecision,
                   adaptive_sketch_capacity, imbalance, local_skew_stats,
                   merge_skew_stats, owner_merge_plan, plan_rebalance,
                   scatter_part_fn)
from .streaming import (DEFAULT_CHUNK_BYTES, DEFAULT_MAX_INFLIGHT, ChunkPlan,
                        StreamSession)
from .templates import (TEMPLATES, ShuffleResult, ShuffleTemplate, register_template,
                        run_shuffle, template_loc)
from .topology import (NetworkTopology, Level, datacenter, degrade_links, fat_tree,
                       from_mesh_axes, multipod_dcn, roofline_times, dominant_term,
                       roofline_fraction)
from .vectorized import (can_vectorize, combine_msgs, run_shuffle_vectorized,
                         set_comb_backend, vectorize_decline)
from .torchplan import (TORCH_TEMPLATES, TorchLowering, decline_reason,
                        kernel_plane_enabled, lower_plan, plan_decline,
                        set_kernel_plane, try_run_torch)
from .convert import msgs_from_reference, plan_from_reference

__all__ = [
    "EffCost", "compute_eff_cost", "eff_cost_from_ratio", "reduction_drift",
    "CoflowRequest",
    "CoflowScheduler", "ScheduleEntry", "ShuffleManager", "ShuffleRecord",
    "COMBINERS", "HASH_PART", "MAX", "MIN", "SUM", "Combiner", "Msgs", "PartFn",
    "partition", "range_part", "splitmix64",
    "CompiledPlan", "LevelDecision", "PlanCache", "compile_plan", "plan_key",
    "skew_bucket", "stats_signature", "CostLedger", "EndOfStream",
    "FaultInjection", "LocalCluster",
    "ShuffleAborted",
    "ShuffleArgs", "WorkerContext", "estimate_reduction_ratio",
    "estimate_reduction_ratio_with_fallback", "group_of",
    "num_groups_for_rate", "partition_aware_sample", "random_sample",
    "reduction_ratio", "sample_with_fallback",
    "DEFAULT_SKEW_THRESHOLD", "HeavyHitterSketch", "LocalSkewStats",
    "MAX_SKETCH_CAPACITY", "MIN_SKETCH_CAPACITY",
    "SkewDecision", "adaptive_sketch_capacity", "imbalance",
    "local_skew_stats", "merge_skew_stats",
    "owner_merge_plan", "plan_rebalance", "scatter_part_fn",
    "dst_load_imbalance",
    "DEFAULT_CHUNK_BYTES", "DEFAULT_MAX_INFLIGHT", "ChunkPlan", "StreamSession",
    "POLICIES", "DEFAULT_TENANT", "AdmissionQueue", "ShuffleSubmission",
    "TenantRegistry", "TenantSpec", "TeShuCluster", "TenantClient",
    "TeShuService", "TEMPLATES", "ShuffleResult",
    "ShuffleTemplate", "register_template", "run_shuffle", "template_loc",
    "NetworkTopology", "Level", "datacenter", "degrade_links", "fat_tree",
    "from_mesh_axes", "multipod_dcn", "roofline_times", "dominant_term",
    "roofline_fraction", "can_vectorize", "combine_msgs",
    "run_shuffle_vectorized", "set_comb_backend", "vectorize_decline",
    "CheckpointStore", "FailureDetector", "FailureReport", "RecoveryContext",
    "RecoveryCoordinator", "SpeculationPolicy", "SpeculativeTask",
    "StreamCheckpoint",
    "consistent_resume_stages", "repair_plan", "try_repair",
    "JOURNAL_VERSION", "key_diff",
    "FlightRecorder", "MetricsRegistry", "NULL_TRACER", "NullTracer",
    "Observability", "ShuffleReport", "build_report",
    "TORCH_TEMPLATES", "TorchLowering", "decline_reason", "lower_plan",
    "plan_decline", "try_run_torch", "kernel_plane_enabled",
    "set_kernel_plane", "plan_from_reference", "msgs_from_reference",
]
