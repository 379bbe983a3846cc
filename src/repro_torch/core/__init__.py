"""Core: the paper's contribution — data-driven DVFS + deadline scheduling.

Layered as: prediction (``predictor`` + ``prediction_service``, GBDT
inference on the device) → policy (``policies``) → execution (``engine``),
with ``scheduler`` wiring them behind the classic ``run_schedule`` entry
point.
"""
from .dvfs import (ClockPair, DVFSConfig, DeviceClass, DEVICE_CLASSES,
                   V5E_CLASS, V5E_DVFS, V5LITE_CLASS, V5P_CLASS)
from .simulator import AppProfile, Measurement, Testbed
from .features import (ALL_INPUT_NAMES, CATEGORICAL_FEATURES, FEATURE_NAMES,
                       build_dataset, profile_features)
from .predictor import (EnergyTimePredictor, PredictorConfig, loocv_rmse,
                        normalized_rmse, split_rmse)
from .correlate import CorrelationIndex
from .workload import (BATCH_TIER, BEST_EFFORT_TIER, DEFAULT_TIER, Job,
                       SLO_TIER, TIERS, TierSpec, cap_stress_workload,
                       drift_profile, drifting_workload, edf_key,
                       heterogeneous_workload, make_device_pool,
                       make_workload, merge_workloads, multi_rack_workload,
                       multi_tenant_workload, rescue_stress_workload,
                       serving_workload, stream_workload, training_workload)
from .admission import AdmissionController, AdmissionStats
from .prediction_service import (ClockTable, PredictionService, ServiceStats,
                                 StackedTable, UnknownAppError)
from .coldstart import (ColdStartConfig, ColdStartStats, ColdStartSynthesizer,
                        static_features)
from .batch_decide import DecisionCore, DecisionStats
from .policies import (BudgetManager, DeviceCandidate, Policy,
                       QueueAwareBudget, RiskAware, VirtualPacingBudget,
                       resolve_policy)
from .engine import EngineHooks, EventEngine
from .scheduler import (POLICIES, ScheduleResult, legacy_run_schedule,
                        run_schedule)
from .online import (DriftConfig, DriftDetector, GBDTCorrector, Observation,
                     ObservationStore, OnlineAdapter, RLSCorrector)
from .powercap import (GRANT_POLICIES, CoordinatorStats, PowerCapCoordinator,
                       PowerSegment, PowerTelemetry)
from .preemption import (PreemptionConfig, PreemptionManager,
                         PreemptionStats)
from .federation import (FACILITY_SHARE_POLICIES, FacilityCoordinator,
                         FacilityStats, FederatedPreemptionManager,
                         FederatedStats, MigrationCostModel,
                         RackCoordinator, RackTopology)
from .model_apps import (KIND_KNOBS, PHASES, derive_app, derive_counters,
                         kernel_apps, model_app_suite, register_model_apps)

__all__ = [
    "ClockPair", "DVFSConfig", "V5E_DVFS",
    "DeviceClass", "DEVICE_CLASSES", "V5E_CLASS", "V5P_CLASS",
    "V5LITE_CLASS",
    "AppProfile", "Measurement", "Testbed",
    "ALL_INPUT_NAMES", "CATEGORICAL_FEATURES", "FEATURE_NAMES",
    "build_dataset", "profile_features",
    "EnergyTimePredictor", "PredictorConfig", "loocv_rmse", "normalized_rmse",
    "split_rmse",
    "CorrelationIndex",
    "Job", "make_workload", "stream_workload", "make_device_pool",
    "drifting_workload", "drift_profile", "heterogeneous_workload",
    "cap_stress_workload", "rescue_stress_workload",
    "multi_tenant_workload", "multi_rack_workload", "serving_workload",
    "training_workload", "merge_workloads",
    "TierSpec", "SLO_TIER", "BATCH_TIER", "BEST_EFFORT_TIER", "DEFAULT_TIER",
    "TIERS", "edf_key",
    "AdmissionController", "AdmissionStats",
    "ClockTable", "PredictionService", "ServiceStats", "StackedTable",
    "UnknownAppError",
    "ColdStartConfig", "ColdStartStats", "ColdStartSynthesizer",
    "static_features",
    "DecisionCore", "DecisionStats",
    "BudgetManager", "DeviceCandidate", "Policy", "QueueAwareBudget",
    "RiskAware", "VirtualPacingBudget", "resolve_policy",
    "EngineHooks", "EventEngine",
    "POLICIES", "ScheduleResult", "run_schedule", "legacy_run_schedule",
    "Observation", "ObservationStore", "RLSCorrector", "GBDTCorrector",
    "DriftConfig", "DriftDetector", "OnlineAdapter",
    "GRANT_POLICIES", "CoordinatorStats", "PowerCapCoordinator",
    "PowerSegment", "PowerTelemetry",
    "PreemptionConfig", "PreemptionManager", "PreemptionStats",
    "FACILITY_SHARE_POLICIES", "FacilityCoordinator", "FacilityStats",
    "FederatedPreemptionManager", "FederatedStats", "MigrationCostModel",
    "RackCoordinator", "RackTopology",
    "KIND_KNOBS", "PHASES", "derive_app", "derive_counters", "kernel_apps",
    "model_app_suite", "register_model_apps",
]
