"""The SCAN engine in PyTorch: graph, σ, GS*-Index, queries, and the
LSH-approximate index."""
from repro_torch.core.graph import (  # noqa: F401
    CSRGraph, from_edge_list, graph_from_dense, hub_ring_graph,
    power_law_graph, random_graph, resolve_device, to_dense,
)
from repro_torch.core.index import (  # noqa: F401
    ScanIndex, build_index, co_core_prefix, get_cores,
)
from repro_torch.core.query import (  # noqa: F401
    ClusterResult, hubs_outliers, query, query_batch,
)
from repro_torch.core.similarity import (  # noqa: F401
    SimilarityPlan, closed_norms, compute_similarities,
    compute_similarities_dense, edge_similarities_subset, plan_for,
    triangle_counts,
)
from repro_torch.core.lsh import (  # noqa: F401
    approximate_similarities, kpartition_edge_similarity,
    kpartition_sketches, minhash_edge_similarity, minhash_sketches,
    simhash_edge_similarity, simhash_sketches,
)
from repro_torch.core.approx import (  # noqa: F401
    EXACT_PROVENANCE, ApproxIndexBuilder, ApproxParams, IndexProvenance,
    build_approx_index,
)
from repro_torch.core.connectivity import connected_components  # noqa: F401
from repro_torch.core.quality import (  # noqa: F401
    adjusted_rand_index, core_precision_recall, modularity,
)
