"""partitionedarrays_tpu: a JAX partitioned sparse linear-algebra
framework with the capabilities of PartitionedArrays.jl.

Public API surface mirrors the reference's export list
(src/PartitionedArrays.jl:14-196 plus PartitionedSolvers and HPCG),
re-designed for accelerators: SPMD code over a ``jax.sharding.Mesh`` (or the
vmap-based serial/debug backend), static halo-exchange plans compiled into
the XLA program, DIA/ELL device sparse formats, and
host-side (numpy/scipy) setup for partitioning and coarsening.
"""

# -- backends (L1) ----------------------------------------------------------
from .backends import (
    AXIS,
    Backend,
    MeshBackend,
    SerialBackend,
    mesh_backend,
    serial_backend,
    with_debug,
    with_mesh,
    with_multihost,
    with_serial,
)
from .config import enable_compilation_cache

# -- local storage & sparse kernels (L2) ------------------------------------
from .ops.jagged import (
    GenericJaggedArray,
    JaggedArray,
    jagged_array,
    length_to_ptrs,
    ptrs_to_lengths,
    rewind_ptrs,
)
from .ops.sparse_host import (
    compresscoo,
    indextype,
    nzindex,
    nziterator,
    precompute_nzindex,
    sparse_matrix,
    sparse_matrix_refill,
    spmtv as spmtv_local,
    spmv as spmv_local,
    split_locally,
    sub_sparse_matrix,
)
from .ops.dia import csr_diagonals, dia_spmv
from .ops.ell import csr_to_ell, ell_spmv
from .ops.stencil import stencil_psparse, stencil_rhs_counts

# -- communication primitives (L3) ------------------------------------------
from .parallel.primitives import (
    MAIN,
    ExchangeGraph,
    allocate_emit,
    emit,
    find_rcv_ids_gather_scatter,
    find_rcv_ids_ibarrier,
    FakeTask,
    allocate_exchange,
    allocate_gather,
    array_of_tuples,
    cartesian_indices,
    exchange,
    fake_async,
    find_rcv_ids,
    gather,
    getany,
    i_am_main,
    is_consistent,
    linear_indices,
    map_main,
    map_parts,
    multicast,
    reduction,
    scan,
    scatter,
    tuple_of_arrays,
)

# -- index partitioning (L4) ------------------------------------------------
from .parallel.p_range import (
    AssemblyGraph,
    LocalIndices,
    PRange,
    assembly_local_indices,
    assembly_neighbors,
    block_owner_1d,
    ghost_length,
    global_length,
    local_length,
    local_permutation,
    map_ghost_to_global,
    map_global_to_ghost,
    own_and_ghost_indices,
    own_length,
    permute_indices,
    find_owner,
    ghost_to_global,
    ghost_to_local,
    ghost_to_owner,
    global_to_ghost,
    global_to_local,
    global_to_own,
    local_range,
    local_to_ghost,
    local_to_global,
    local_to_own,
    local_to_owner,
    map_global_to_local,
    map_global_to_own,
    map_local_to_global,
    map_own_to_global,
    matching_ghost_indices,
    matching_local_indices,
    matching_own_indices,
    own_to_global,
    own_to_local,
    own_to_owner,
    part_id,
    partition,
    partition_from_color,
    remove_ghost,
    renumber_partition,
    replace_ghost,
    to_global,
    to_local,
    trivial_partition,
    uniform_partition,
    union_ghost,
    variable_partition,
)
from .parallel.exchange_plan import ExchangePlan, VectorLayout

# -- distributed containers (L5) --------------------------------------------
from .pvector import (
    PVector,
    Task,
    assemble,
    axpy,
    collect,
    consistent,
    find_local_indices,
    pall,
    pany,
    pchebyshev,
    pcityblock,
    pdot,
    pdistance,
    peuclidean,
    pfill,
    pmaximum,
    pminimum,
    pnorm,
    pones,
    prand,
    prandn,
    psqeuclidean,
    psum_reduce,
    pvector,
    pvector_df64,
    pvector_refill,
    pvector_split_df64,
    pdot_df64,
    pnorm_df64,
    axpy_df64,
    collect_df64,
    pvector_from_local,
    pvector_local,
    pvector_from_own,
    pvector_from_split_blocks,
    split_vector,
    split_vector_blocks,
    pzeros,
    renumber_pvector,
    repartition,
)
from .psparse import (
    DeviceSpMat,
    PSparseMatrix,
    assemble_matrix,
    assemble_matrix_into,
    centralize,
    consistent_matrix,
    consistent_matrix_into,
    dense_diag,
    identity_minus,
    psparse,
    psparse_from_blocks,
    psparse_from_global,
    psparse_local,
    psparse_refill,
    psystem,
    psystem_refill,
    rap,
    rap_into,
    renumber_matrix,
    repartition_matrix,
    repartition_system,
    sparse_diag_matrix,
    split_format,
    split_matrix,
    split_matrix_blocks,
    spmm,
    spmm_into,
    spmtm,
    spmtm_into,
    spmtv,
    spmv,
    to_global_scipy,
    transpose_psparse,
)
from .block_arrays import (
    BMatrix,
    BRange,
    BVector,
    b_all,
    b_any,
    b_assemble,
    b_axpy,
    b_cg,
    b_collect,
    b_consistent,
    b_dot,
    b_euclidean,
    b_maximum,
    b_minimum,
    b_mul,
    b_norm,
    b_sum,
)

# -- solvers (L6) -----------------------------------------------------------
from .solvers.krylov import (
    CGInfo,
    cg,
    cg_df64,
    pipelined_cg,
    richardson_iteration,
)
from .solvers.smoothers import (
    AdditiveSchwarz,
    GaussSeidel,
    JacobiCorrection,
    additive_schwarz,
    gauss_seidel,
    greedy_coloring,
    identity_solver,
    jacobi,
)
from .solvers.amg import (
    AMGLevel,
    AMGParams,
    AMGPreconditioner,
    aggregate,
    amg,
    constant_prolongator,
    default_nullspace,
    smoothed_prolongator,
    spectral_radius,
    tentative_prolongator,
)
from .solvers.interfaces import (
    LinearProblem,
    NonlinearProblem,
    ODEProblem,
    additive_schwarz_solver,
    amg_solver,
    cg_solver,
    gauss_seidel_solver,
    history,
    jacobi_solver,
    lu_solver,
    preconditioner,
    richardson_solver,
    smooth,
    solve,
)
from .solvers.nonlinear import NewtonInfo, newton_krylov, newton_raphson
from .solvers.ode import backward_euler, single_stage_solver

# -- gallery / benchmarks (L7) ----------------------------------------------
from .models.gallery import (
    laplacian_fdm,
    plaplacian_fdm,
    laplacian_fem,
    linear_elasticity_fem,
    node_coordinates_unit_cube,
    near_nullspace_linear_elasticity,
    node_to_dof_partition,
    nullspace_linear_elasticity,
)
from .models.hpcg.problem import build_hpcg_problem
from .models.hpcg.mg import HPCGMGPreconditioner
from .models.hpcg.cg import hpcg_cg
from .models.hpcg.driver import hpcg_benchmark
from .models.hpcg.report import HPCGReport
from .models.hpcg.opt3d import compute_optimal_shape_xyz
from .models.hpcg import (
    build_matrix,
    build_p_matrix,
    hpcg_benchmark_debug,
    hpcg_benchmark_mesh,
    hpcg_benchmark_mpi,
    opt_cg,
    pc_setup,
    pc_solve,
    ref_cg,
)

# -- utilities --------------------------------------------------------------
from .utils.ptimer import PTimer, barrier, current_time

# -- reference-name compatibility surface ------------------------------------
from .parallel.primitives import allocate_multicast, allocate_scatter
from .compat import (
    AbstractLocalIndices,
    assembly_graph,
    BArray,
    DebugArray,
    GhostIndices,
    MPIArray,
    OwnAndGhostIndices,
    OwnAndGhostVectors,
    OwnIndices,
    PermutedLocalIndices,
    SplitMatrix,
    SplitVector,
    old_psparse,
    old_pvector,
    distribute_with_mpi,
    ghost_ghost_values,
    ghost_own_values,
    ghost_values,
    global_to_owner,
    laplace_matrix,
    local_values,
    own_ghost_values,
    own_own_values,
    own_values,
    psparse_from_split_blocks,
    renumber,
    statistics,
    tic,
    toc,
    with_mpi,
)

__version__ = "0.1.0"
