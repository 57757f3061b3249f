# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The launcher: the ``bfrun-torch`` / ``ibfrun-torch`` console commands.

Counterpart of ``bluefog_tpu/run/``: environment preparation (the worker
counts and the timeline and flight knobs), multi-process bring-up (one
process per ``-H`` entry, local or over ssh, with the rendezvous
coordinates of :func:`bluefog_tpu_torch.context.maybe_init_distributed`),
and running the user command. Standard library only.
"""

from bluefog_tpu_torch.run import network_util  # noqa: F401
