"""TPUJob API: types, constants, defaulting, validation.

Reference parity: pkg/apis/tensorflow/{v1,validation} plus the shared
kubeflow/common/pkg/apis/common/v1 types.
"""

from tf_operator_tpu_torch.api import constants  # noqa: F401
from tf_operator_tpu_torch.api.defaults import set_defaults  # noqa: F401
from tf_operator_tpu_torch.api.types import (  # noqa: F401
    CleanPodPolicy,
    ClusterQueue,
    ClusterQueueSpec,
    ClusterQueueStatus,
    ConditionStatus,
    Container,
    Endpoint,
    EndpointSpec,
    JobCondition,
    JobConditionType,
    JobStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
    ReclaimPolicy,
    ReplicaSpec,
    ReplicaStatus,
    ReplicaType,
    RestartPolicy,
    RunPolicy,
    SchedulingPolicy,
    ServingPolicy,
    SliceGroup,
    SliceGroupSpec,
    SuccessPolicy,
    TenantQueue,
    TenantQueueSpec,
    TenantQueueStatus,
    TPUJob,
    TPUJobSpec,
    TPUSliceSpec,
    gen_general_name,
    is_chief_or_master,
    is_evaluator,
    is_serving,
    is_worker,
)
from tf_operator_tpu_torch.api.validation import (  # noqa: F401
    ValidationError,
    validate_cluster_queue,
    validate_job,
    validate_tenant_queue,
)
