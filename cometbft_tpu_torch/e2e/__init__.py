"""Manifest-driven e2e testnets (counterpart of ``cometbft_tpu/e2e``;
reference: ``test/e2e``)."""

from .manifest import (Manifest, ManifestError, NodeManifest,
                       load_manifest, manifest_from_dict)
from .runner import Runner, RunnerError, free_port_base

__all__ = ["Manifest", "ManifestError", "NodeManifest", "Runner",
           "RunnerError", "free_port_base", "load_manifest",
           "manifest_from_dict"]
