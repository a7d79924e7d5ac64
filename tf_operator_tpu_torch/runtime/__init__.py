"""Runtime: workqueue, events, object store, cluster backends.

Reference parity: the client-go machinery the reference leans on (rate
limited workqueues, event recorder, informer caches) plus the data plane
the reference delegates to kubelet — rebuilt here as a process-native
runtime so the whole control loop runs hermetically.
"""
