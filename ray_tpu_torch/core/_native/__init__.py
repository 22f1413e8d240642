"""Native seam package: ctypes bindings over libraytpu_torch_store.so.

Two planes live in the shared library (built from csrc/ on demand):
the object-store sidecar (bound in core/object_store.py, predating this
package) and the graftrpc dispatch reactor (bound in graftrpc here).
Build artifacts (.so, test binaries) land in this directory and are
gitignored; the Python seams are source.
"""
