"""The planning layer: the paper's exploration on an extracted LM workload
(model configuration → application graph → NSGA-II over ξ, C_d, β_A →
CAPS-HMS), mapped onto a modelled TPU pod architecture."""
from .extract import extract_application_graph
from .tpu_arch import tpu_pod_architecture
from .plan import DataflowPlan, plan_mapping
