"""Core HFEL path of the port: cost model, scenario generation and churn,
resource allocation, edge association and hierarchical aggregation (the
names ``repro.core`` exports) and update compression."""

from repro_torch.core.cost_model import (DeviceParams, LearningParams,
                                         RAConstants, ServerParams,
                                         global_cost, ra_constants,
                                         ra_objective)
from repro_torch.core.scenario import (DeviceClientBridge, Scenario,
                                       ScenarioDelta, device_client_bridge,
                                       diff_scenarios, make_large_scenario,
                                       make_scenario, perturb_scenario)
from repro_torch.core.resource_allocation import (RASolution, beta_of_f,
                                                  solve, solve_exact,
                                                  solve_fixed_point,
                                                  solve_paper,
                                                  solve_reference)
from repro_torch.core.edge_association import (AssociationEngine,
                                               AssociationResult,
                                               GroupSolver,
                                               NoFeasibleServerError,
                                               evaluate_scheme,
                                               greedy_admission,
                                               nearest_feasible,
                                               parked_slots, solve_group)
from repro_torch.core.assoc_fast import (FastAssociationEngine,
                                         assignment_true_cost,
                                         repair_assignment)
from repro_torch.core.hierarchy import (SyncLevel, SyncSchedule,
                                        cloud_aggregate, edge_aggregate,
                                        hierarchical_sync, psum_mean)
from repro_torch.core.compression import Int8Compressor, TopKCompressor

__all__ = [
    "DeviceParams", "LearningParams", "RAConstants", "ServerParams",
    "global_cost", "ra_constants", "ra_objective",
    "DeviceClientBridge", "Scenario", "ScenarioDelta",
    "device_client_bridge", "diff_scenarios", "make_large_scenario",
    "make_scenario", "perturb_scenario",
    "RASolution", "beta_of_f", "solve", "solve_exact", "solve_fixed_point",
    "solve_paper", "solve_reference",
    "AssociationEngine", "AssociationResult", "FastAssociationEngine",
    "GroupSolver", "NoFeasibleServerError", "assignment_true_cost",
    "evaluate_scheme", "greedy_admission", "nearest_feasible",
    "parked_slots", "repair_assignment", "solve_group",
    "SyncLevel", "SyncSchedule", "cloud_aggregate", "edge_aggregate",
    "hierarchical_sync", "psum_mean",
    "Int8Compressor", "TopKCompressor",
]
