# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Applications written against the port (``pde``: the port of
``examples/pde.py``)."""
