"""Logical-axis sharding, the half that runs outside a device mesh.

Model and round code name *logical* axes ('clients', 'embed', 'heads',
...), never devices: ``init`` returns a parameter tree with its twin tree
of logical-axis tuples (``param_axes``), and the round engine constrains
the per-client replicas and the scan accumulator by it where the JAX
package's ``core/round.py`` does.  Outside a mesh, which is all the port
has, the constraints are identities, as the reference's ``shard`` and
``shard_tree`` are without a live mesh: the same calls run on one card
and, once the mesh is ported, across many.  The rule tables, the mesh
context and the sharded layouts come with the mesh slice (ROADMAP Queue
1, the mesh); ``ExecutionPlan(mesh=...)`` raises ``PlanError`` until then.
"""
from __future__ import annotations

from typing import Any, Optional


def shard(x, *axes: Optional[str]):
    """Constrain ``x``'s placement by logical axes: the identity outside a
    mesh (the reference checks the rank only under a live mesh)."""
    return x


def shard_tree(tree: Any, axes_tree: Any, prefix: tuple = ()) -> Any:
    """Constrain a whole tree by its logical-axes twin tree (``prefix``
    prepends axes, e.g. ``('clients',)`` for the per-client replicas): the
    tree itself outside a mesh."""
    return tree
