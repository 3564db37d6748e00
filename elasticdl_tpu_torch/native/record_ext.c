/* CPython extension: RecordFile range reads with zero Python-loop cost.
 *
 * Same format as data/record_file.py (header EDLR|u32 version, body
 * [u32 len|payload]*, index u64 offsets, footer u64 index_offset|
 * u64 num_records|EDLI; little-endian). The Python scanner pays ~2us of
 * interpreter overhead per record (read+unpack per record); a ctypes
 * batch-copy design was measured SLOWER because re-slicing the batch
 * into bytes objects costs another full pass in Python. This extension
 * mmaps the file and builds the final list[bytes] directly in C — one
 * memcpy per record, no Python-side loop at all. This is the data-plane
 * hot-loop role the reference fills with native code (SURVEY.md §2.4).
 *
 * The PyTorch port's own copy of the JAX package's extension. Built
 * lazily by native/__init__.py (gcc via subprocess, into native/_build/
 * under a name keyed on the source, the flags and the interpreter's
 * SOABI); loaded as module _record_ext with:
 *   read_range(path, start, count) -> list[bytes]
 *   num_records(path) -> int
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

static const char kMagic[4] = {'E', 'D', 'L', 'R'};
static const char kFooterMagic[4] = {'E', 'D', 'L', 'I'};
#define HEADER_SIZE 8
#define FOOTER_SIZE 20

typedef struct {
    const uint8_t *data;
    int64_t size;
    int64_t num_records;
    const uint8_t *index; /* u64 offsets, possibly unaligned */
} RecordFile;

static uint32_t load_u32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, sizeof(v));
    return v;
}

static uint64_t load_u64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, sizeof(v));
    return v;
}

/* 0 on success; sets a Python exception otherwise. */
static int rf_map(const char *path, RecordFile *rf) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
        PyErr_Format(PyExc_ValueError, "%s: not a valid RecordFile",
                     path);
        return -1;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 ||
        st.st_size < HEADER_SIZE + FOOTER_SIZE) {
        close(fd);
        PyErr_Format(PyExc_ValueError, "%s: not a valid RecordFile",
                     path);
        return -1;
    }
    void *mapped = mmap(NULL, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (mapped == MAP_FAILED) {
        PyErr_Format(PyExc_ValueError, "%s: mmap failed", path);
        return -1;
    }
    const uint8_t *data = (const uint8_t *)mapped;
    int64_t size = st.st_size;
    const uint8_t *footer = data + size - FOOTER_SIZE;
    if (memcmp(data, kMagic, 4) != 0 || load_u32(data + 4) != 1 ||
        memcmp(footer + 16, kFooterMagic, 4) != 0) {
        munmap(mapped, size);
        PyErr_Format(PyExc_ValueError, "%s: not a valid RecordFile",
                     path);
        return -1;
    }
    int64_t index_offset = (int64_t)load_u64(footer);
    int64_t num_records = (int64_t)load_u64(footer + 8);
    /* Bound num_records FIRST so 8*num_records cannot overflow and
     * sneak a corrupt footer past the range check. */
    int64_t max_records = (size - HEADER_SIZE - FOOTER_SIZE) / 8;
    if (num_records < 0 || num_records > max_records ||
        index_offset < HEADER_SIZE ||
        index_offset + 8 * num_records + FOOTER_SIZE > size) {
        munmap(mapped, size);
        PyErr_Format(PyExc_ValueError, "%s: corrupt RecordFile index",
                     path);
        return -1;
    }
    rf->data = data;
    rf->size = size;
    rf->num_records = num_records;
    rf->index = data + index_offset;
    return 0;
}

static void rf_unmap(RecordFile *rf) {
    munmap((void *)rf->data, rf->size);
}

static PyObject *py_read_range(PyObject *self, PyObject *args) {
    const char *path;
    long long start, count;
    if (!PyArg_ParseTuple(args, "sLL", &path, &start, &count))
        return NULL;
    RecordFile rf;
    if (rf_map(path, &rf) != 0)
        return NULL;
    if (start < 0 || count < 0 || start + count > rf.num_records) {
        rf_unmap(&rf);
        PyErr_Format(PyExc_ValueError,
                     "%s: range [%lld, %lld) out of bounds (n=%lld)",
                     path, start, start + count,
                     (long long)rf.num_records);
        return NULL;
    }
    PyObject *list = PyList_New((Py_ssize_t)count);
    if (!list) {
        rf_unmap(&rf);
        return NULL;
    }
    for (long long i = 0; i < count; ++i) {
        int64_t off = (int64_t)load_u64(rf.index + 8 * (start + i));
        if (off < 0 || off + 4 > rf.size) goto corrupt;
        uint32_t len = load_u32(rf.data + off);
        if (off + 4 + (int64_t)len > rf.size) goto corrupt;
        PyObject *b = PyBytes_FromStringAndSize(
            (const char *)rf.data + off + 4, (Py_ssize_t)len);
        if (!b) {
            Py_DECREF(list);
            rf_unmap(&rf);
            return NULL;
        }
        PyList_SET_ITEM(list, (Py_ssize_t)i, b);
    }
    rf_unmap(&rf);
    return list;
corrupt:
    Py_DECREF(list);
    rf_unmap(&rf);
    PyErr_Format(PyExc_ValueError, "%s: corrupt RecordFile", path);
    return NULL;
}

static PyObject *py_num_records(PyObject *self, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;
    RecordFile rf;
    if (rf_map(path, &rf) != 0)
        return NULL;
    long long n = (long long)rf.num_records;
    rf_unmap(&rf);
    return PyLong_FromLongLong(n);
}

static PyMethodDef Methods[] = {
    {"read_range", py_read_range, METH_VARARGS,
     "read_range(path, start, count) -> list[bytes]"},
    {"num_records", py_num_records, METH_VARARGS,
     "num_records(path) -> int"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_record_ext",
    "Native RecordFile range reader", -1, Methods,
};

PyMODINIT_FUNC PyInit__record_ext(void) {
    return PyModule_Create(&moduledef);
}
