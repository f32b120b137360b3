import os

# the threads of host work that releases the GIL: decoding and writing a
# checkpoint's arrays, the copies of a weight map (orbax_reader,
# orbax_writer, convert)
HOST_THREADS = min(8, os.cpu_count() or 1)
