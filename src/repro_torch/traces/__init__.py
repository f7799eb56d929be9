from .agentic import (TraceConfig, generate_conversation, generate_trace,
                      workload_stats, SCENARIOS, make_scenario, pareto_burst,
                      supervisor_worker, supervisor_worker_dag, hitl_longpark,
                      shared_preamble_fleet)
