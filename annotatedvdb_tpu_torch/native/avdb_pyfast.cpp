// avdb_pyfast: CPython helpers for the native VEP apply path.
//
// After the C++ transformer (avdb_vep.cpp) emits per-row JSON text, the
// remaining cost of the VEP load is assembling Python-side row values:
// one str slice + one RawJson wrapper per (row, column).  Doing that in a
// Python loop costs ~1.5-2us per value; this extension builds the whole
// column list in C (~0.3us/value), reusing one wrapper for consecutive
// rows that share a span (a doc's vep_output is shared by its alts, and
// sharing RawJson is safe — it is immutable by contract).
//
// The RawJson class itself stays defined in Python
// (store/variant_store.py); its two __slots__ are filled directly through
// their member-descriptor offsets.  The binding probes correctness of that
// layout assumption at load time and raises if the probe fails
// (native/pyfast.py).
//
// Build: g++ -O3 -shared -fPIC -I<python-include> (see native/pyfast.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <cstdint>

namespace {

// member-descriptor slot offset of attribute `name` on `type`
Py_ssize_t slot_offset(PyObject* type, const char* name) {
    PyObject* descr = PyObject_GetAttrString(type, name);
    if (descr == nullptr) return -1;
    Py_ssize_t off = -1;
    if (PyObject_TypeCheck(descr, &PyMemberDescr_Type)) {
        off = ((PyMemberDescrObject*)descr)->d_member->offset;
    } else {
        PyErr_Format(PyExc_TypeError, "%s is not a slot member", name);
    }
    Py_DECREF(descr);
    return off;
}

// raw_rows(arena: str, offs: int64 buffer, lens: int32 buffer,
//          raw_type: type) -> list
// Each row: lens[i] == 0 -> a fresh empty dict; else a raw_type instance
// whose 'text' slot is arena[offs[i]:offs[i]+lens[i]] and whose '_obj'
// slot is None.  Consecutive equal (off, len) rows share one instance.
PyObject* raw_rows(PyObject*, PyObject* args) {
    PyObject* arena;
    Py_buffer offs, lens;
    PyObject* raw_type;
    if (!PyArg_ParseTuple(args, "Uy*y*O", &arena, &offs, &lens, &raw_type))
        return nullptr;
    Py_ssize_t n = offs.len / (Py_ssize_t)sizeof(int64_t);
    const int64_t* po = (const int64_t*)offs.buf;
    const int32_t* pl = (const int32_t*)lens.buf;
    PyObject* out = nullptr;
    Py_ssize_t off_text = -1, off_obj = -1;
    if (lens.len / (Py_ssize_t)sizeof(int32_t) != n) {
        PyErr_SetString(PyExc_ValueError, "offs/lens length mismatch");
        goto done;
    }
    off_text = slot_offset(raw_type, "text");
    off_obj = slot_offset(raw_type, "_obj");
    if (off_text < 0 || off_obj < 0) goto done;
    out = PyList_New(n);
    if (out == nullptr) goto done;
    {
        PyTypeObject* tp = (PyTypeObject*)raw_type;
        int64_t prev_off = -1;
        int32_t prev_len = -1;
        PyObject* prev = nullptr;  // borrowed from the list
        for (Py_ssize_t i = 0; i < n; ++i) {
            PyObject* v;
            if (pl[i] == 0) {
                v = PyDict_New();
            } else if (prev != nullptr && po[i] == prev_off
                       && pl[i] == prev_len) {
                Py_INCREF(prev);
                v = prev;
            } else {
                PyObject* text = PyUnicode_Substring(
                    arena, (Py_ssize_t)po[i], (Py_ssize_t)(po[i] + pl[i]));
                if (text == nullptr) { Py_DECREF(out); out = nullptr; goto done; }
                v = tp->tp_alloc(tp, 0);
                if (v == nullptr) {
                    Py_DECREF(text);
                    Py_DECREF(out);
                    out = nullptr;
                    goto done;
                }
                // tp_alloc zero-fills: both slots are NULL; fill them
                *(PyObject**)((char*)v + off_text) = text;  // steal text ref
                Py_INCREF(Py_None);
                *(PyObject**)((char*)v + off_obj) = Py_None;
                prev = v;
                prev_off = po[i];
                prev_len = pl[i];
            }
            if (v == nullptr) { Py_DECREF(out); out = nullptr; goto done; }
            PyList_SET_ITEM(out, i, v);  // steals v
        }
    }
done:
    PyBuffer_Release(&offs);
    PyBuffer_Release(&lens);
    return out;
}

PyMethodDef methods[] = {
    {"raw_rows", raw_rows, METH_VARARGS,
     "Build a list of RawJson wrappers (or empty dicts) from span arrays."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "avdb_pyfast",
    "C assembly of RawJson column lists for the native VEP path.",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_avdb_pyfast(void) {
    return PyModule_Create(&moduledef);
}
