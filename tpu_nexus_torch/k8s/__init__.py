"""Kubernetes client plane (reference L1, SURVEY.md §1): a copy of
``tpu_nexus/k8s``.

The reference uses client-go shared informers + a typed clientset
(services/supervisor.go:16-18,71-75).  Equivalent here:

  objects.py   — typed views over k8s API JSON (Event/Pod/Job/JobSet)
  client.py    — KubeClient interface + aiohttp REST implementation
                 (LIST+WATCH streaming, in-cluster & kubeconfig auth)
  fake.py      — in-process fake client replaying seeded objects
                 (client-go `fake.NewClientset` parity, SURVEY §3.4)
  informer.py  — shared informer factory: list+watch per kind, local cache,
                 handler fan-out, cache-sync barrier
"""

from tpu_nexus_torch.k8s.objects import EventObj, JobObj, JobSetObj, PodObj  # noqa: F401
from tpu_nexus_torch.k8s.informer import SharedInformerFactory  # noqa: F401
from tpu_nexus_torch.k8s.fake import FakeKubeClient  # noqa: F401
