"""Test-support utilities: synthetic MPEG-1/2/2.5 Layer III and Layer
I/II stream generation (``mp3gen``), program material for real encoders
(``signals``), the reference binary (``golden``) and the external
production decoders and encoders (``avref`` over libavcodec,
``mpg123ref`` over libmpg123)."""
