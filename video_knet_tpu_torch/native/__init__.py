"""The port's native data-path code: a PNG reader and writer with no PIL
(`png_codec.py`), whose scanline unfilter is C++ built by g++ at first use
(`build.py`)."""
