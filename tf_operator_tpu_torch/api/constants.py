"""API-group constants for the TPUJob kind.

Reference parity: pkg/apis/tensorflow/v1/constants.go:21-34 and
register.go:33-74 define group "kubeflow.org", kind "TFJob", default
container "tensorflow" and default port "tfjob-port"=2222. The TPU-native
framework keeps the same shape with TPU-appropriate values.

The GPU port keeps the API as it stands (group, kind, container and port
names, labels, annotations), so one job file runs under either control
plane; only the device resource differs (``RESOURCE_GPU``).
"""

# API group/version/kind (reference: pkg/apis/tensorflow/v1/register.go:33-44).
GROUP = "tpu-operator.dev"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "TPUJob"
PLURAL = "tpujobs"
SINGULAR = "tpujob"
# Fully-qualified resource name, analog of "tfjobs.kubeflow.org".
CRD_NAME = f"{PLURAL}.{GROUP}"

# The container that receives cluster-bootstrap env injection.
# Reference: DefaultContainerName = "tensorflow" (constants.go:24).
DEFAULT_CONTAINER_NAME = "jax"

# Named port on which replicas rendezvous. The reference used the TF gRPC
# port 2222 ("tfjob-port", constants.go:27-31); TPU workers conventionally
# expose the libtpu worker port 8470.
DEFAULT_PORT_NAME = "tpujob-port"
DEFAULT_PORT = 8470

# Port the jax.distributed coordination service listens on (process 0).
# No reference analog — TF_CONFIG needed no coordinator; JAX does.
DEFAULT_COORDINATOR_PORT = 8476

# Env var overriding the namespace the operator watches.
# Reference: EnvKubeflowNamespace (constants.go:34).
ENV_OPERATOR_NAMESPACE = "TPU_OPERATOR_NAMESPACE"

# Env var appended to replica DNS names, for clusters with a non-default
# domain. Reference: EnvCustomClusterDomain (tensorflow.go:30-33).
ENV_CUSTOM_CLUSTER_DOMAIN = "CUSTOM_CLUSTER_DOMAIN"

# Well-known labels stamped on every pod/endpoint the engine creates.
# Reference: vendor/.../common/pkg/apis/common/v1/constants.go:3-18.
LABEL_GROUP_NAME = "group-name"
LABEL_JOB_NAME = "job-name"
LABEL_REPLICA_TYPE = "replica-type"
LABEL_REPLICA_INDEX = "replica-index"
LABEL_JOB_ROLE = "job-role"
JOB_ROLE_MASTER = "master"

# Gang-scheduling annotations (reference: tensorflow/pod.go:221-235 uses
# Volcano's scheduling.k8s.io/group-name + volcano.sh/task-spec).
ANNOTATION_GANG_GROUP = "scheduling.tpu-operator.dev/group-name"
ANNOTATION_GANG_TASK = "scheduling.tpu-operator.dev/task-spec"
# Digest of the bootstrap env rendered into the pod at creation. When a
# live pod's digest no longer matches the job's current topology (e.g.
# an elastic resize changed the dense cluster spec / world size), the
# engine restarts it so every process rejoins the new world from the
# latest checkpoint. Sparse-elastic workers' env doesn't embed peers,
# so resizes leave them running (reference enableDynamicWorker
# semantics, tensorflow.go:64-83).
ANNOTATION_BOOTSTRAP_HASH = "tpu-operator.dev/bootstrap-hash"

DEFAULT_GANG_SCHEDULER = "slice-gang"

# Node label naming the fabric domain a GPU node belongs to: NVLink
# within an HGX host, the NVLink/InfiniBand island across hosts. All
# hosts of one slice must land inside one domain (crossing it means the
# slower data-center network). On GKE a GPU node pool is such a domain,
# so the binder falls back to the node-pool label when the first-class
# label is absent. No reference analog — the reference delegated
# placement to Volcano, which is topology-blind.
LABEL_NVLINK_DOMAIN = "tpu-operator.dev/nvlink-domain"
LABEL_GKE_NODEPOOL = "cloud.google.com/gke-nodepool"

# The extended-resource name the NVIDIA device plugin advertises on
# nodes and pods request GPUs under. Doubles as the taint key GKE GPU
# node pools carry — GPU-holding pods get a matching toleration stamped
# at create time (gpu_controller.set_cluster_spec) so the taint manager
# doesn't evict what the scheduler placed.
RESOURCE_GPU = "nvidia.com/gpu"

# Checkpoint coordination (controller/ckpt.py). The preemption notice is
# stamped on a gang's pods when a planned disruption (drain / quota
# reclaim) requests a save-before-evict barrier; value is JSON
# {"barrier": id, "deadline": RFC3339, "reason": str}. The data plane
# forwards it to the worker process as a file (env below), the training
# loop forces a final save and acks through its CheckpointRecord.
ANNOTATION_PREEMPT_NOTICE = "tpu-operator.dev/preemption-notice"

# Node-agent relay (runtime/nodeagent.py, the DaemonSet plane for
# --backend kube). The controller stamps a per-incarnation relay token
# on pods it creates when a relay directory is configured: the agent and
# the rendered TPUJOB_*_FILE env derive file paths from the token, so a
# recreated pod (same name, new incarnation) never reads the dead
# incarnation's notice. The agent mirrors the worker's checkpoint file
# back by PATCHing its JSON onto the ckpt-state annotation, which the
# operator converts into the pod's CheckpointRecord; the heartbeat
# annotation on the Node is how the operator decides a node is
# barrier-capable (a stale/absent agent degrades drains to plain
# eviction instead of hanging on a barrier nobody will relay).
ANNOTATION_RELAY_TOKEN = "tpu-operator.dev/relay-token"
ANNOTATION_CKPT_STATE = "tpu-operator.dev/ckpt-state"
ANNOTATION_AGENT_HEARTBEAT = "tpu-operator.dev/agent-heartbeat"

# Env the data plane gives every pod it spawns: where the preemption
# notice will appear, and where the worker publishes its checkpoint
# state (saves / barrier acks / restore confirmation) for the plane to
# mirror into its CheckpointRecord.
ENV_PREEMPT_FILE = "TPUJOB_PREEMPT_FILE"
ENV_CKPT_FILE = "TPUJOB_CKPT_FILE"

# Env the controller renders from the job's CheckpointPolicy at pod
# create time (tpu_controller.set_cluster_spec). TPUJOB_RESTORE_STEP is
# only present when a committed checkpoint exists — restart-with-identity
# resumes where the barrier saved. None of these enter the bootstrap
# hash: a new checkpoint must not restart live pods.
ENV_CKPT_DIR = "TPUJOB_CKPT_DIR"
ENV_CKPT_INTERVAL_STEPS = "TPUJOB_CKPT_INTERVAL_STEPS"
ENV_CKPT_INTERVAL_SECONDS = "TPUJOB_CKPT_INTERVAL_SECONDS"
ENV_CKPT_MAX_TO_KEEP = "TPUJOB_CKPT_MAX_TO_KEEP"
ENV_RESTORE_STEP = "TPUJOB_RESTORE_STEP"

# Env the controller renders from the job's ServingPolicy into
# serving-role pods when --enable-serving is on (controller/serving.py;
# without the flag the serving role is inert — pods run their command
# with none of these set). Outside the bootstrap hash like the ENV_CKPT_*
# family: a ServingPolicy edit or quota-weight change must not restart
# live serving replicas mid-traffic.
ENV_SERVE_SPOOL = "TPUJOB_SERVE_SPOOL"
ENV_SERVE_SLOTS = "TPUJOB_SERVE_SLOTS"
ENV_SERVE_MAX_QUEUE = "TPUJOB_SERVE_MAX_QUEUE"
ENV_SERVE_MAX_TOKENS = "TPUJOB_SERVE_MAX_TOKENS"
# 'tenant=weight,...' — the per-tenant QoS lane weights, derived from
# the namespace's TenantQueues (weight = the backing ClusterQueue's
# nominal chips), so request-level fair share follows the same handle
# that decides chip fair share (docs/quota.md).
ENV_SERVE_TENANT_WEIGHTS = "TPUJOB_SERVE_TENANT_WEIGHTS"

# Env the controller renders into non-data-plane roles that carry an
# explicit RolePolicy (RL actors; docs/rl.md): comma-joined
# 'dns:port' endpoints of the job's learner (ranked) replicas, the
# addresses an actor dials to stream experience / fetch parameters.
# Outside the bootstrap hash like the ENV_CKPT_*/ENV_SERVE_* families —
# and the actors' own membership is outside the LEARNERS' hashes — so
# actor churn and learner discovery never restart anything.
ENV_LEARNER_ENDPOINTS = "TPUJOB_LEARNER_ENDPOINTS"

# Env the controller renders into every pod that holds no GPU (its
# ``pod_gpus`` is 0: chief, ps and evaluator pods, a chipConsuming:false
# role, every pod of a job with neither a slice nor an nvidia.com/gpu
# request): the device its payload runs on, ``cpu``, as a JAX process on
# such a pod runs on its host's default device. ``_device.resolve_device``
# reads it where the caller names no device. Outside the bootstrap hash
# like the ENV_CKPT_*/ENV_SERVE_* families: a pod's device is not
# cluster membership.
ENV_DEVICE = "TPUJOB_DEVICE"
DEVICE_NO_GPU = "cpu"
